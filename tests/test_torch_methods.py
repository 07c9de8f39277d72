# -*- coding: utf-8 -*-
# The port's data-object methods against syncopy_tpu on the CPU: the nine
# arithmetic operators (scalars, arrays, objects, in-place selections),
# concat and redefinetrial. Both packages compute these in numpy on the
# host, so results are held bitwise (values, dtype, trialdefinition,
# labels), and the error cases raise the same SPY* error types.

import numpy as np
import pytest

import syncopy_tpu as spy
import syncopy_tpu_torch as spt


@pytest.fixture(autouse=True)
def _compute_on_cpu():
    """Ask the port for the CPU explicitly; restore the setting after."""
    previous = spt.set_device("cpu")
    yield
    spt.set_device(previous)


FS = 250.0
OPS = {
    "add": lambda a, b: a + b,
    "radd": lambda a, b: b + a,
    "sub": lambda a, b: a - b,
    "rsub": lambda a, b: b - a,
    "mul": lambda a, b: a * b,
    "rmul": lambda a, b: b * a,
    "truediv": lambda a, b: a / b,
    "rtruediv": lambda a, b: b / a,
    "pow": lambda a, b: a ** b,
}


def _analog(pkg, seed=0, trl=None):
    rng = np.random.default_rng(seed)
    data = (rng.normal(size=(400, 5)) + 3.0).astype("f4")
    if trl is None:
        trl = np.array([[0, 100, -10], [100, 200, 0], [200, 300, 5], [300, 400, 0]], float)
    return pkg.AnalogData(data=data, samplerate=FS, trialdefinition=trl,
                          channel=["c{}".format(k) for k in range(5)])


def _spectral(pkg, seed=1):
    rng = np.random.default_rng(seed)
    spec = (rng.normal(size=(3, 2, 6, 4)) + 1j * rng.normal(size=(3, 2, 6, 4))).astype("c8")
    return pkg.SpectralData(data=spec, samplerate=FS, freq=np.arange(6.0),
                            trialdefinition=np.array([[0, 1, 0], [1, 2, 0], [2, 3, 0]], float))


def _bitwise(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()


def _assert_same(got, want):
    assert type(got).__name__ == type(want).__name__
    assert list(got.dimord) == list(want.dimord)
    _bitwise(got.data, want.data)
    _bitwise(got.trialdefinition, want.trialdefinition)
    assert got.samplerate == want.samplerate
    for name in ("channel", "freq", "taper"):
        if name in want.dimord:
            assert np.asarray(getattr(got, name)).tolist() == np.asarray(getattr(want, name)).tolist()
    for k in range(len(want.trials)):
        _bitwise(got.trials[k], want.trials[k])


def _operands(kind, pkg):
    if kind == "scalar":
        return 2.5
    if kind == "int":
        return 3
    if kind == "array":  # broadcast over every sample of every trial
        return np.linspace(0.5, 2.0, 5).astype("f4")
    if kind == "trial_array":
        return np.random.default_rng(7).uniform(0.5, 2.0, size=(100, 5)).astype("f4")
    return _analog(pkg, seed=1)


# numpy arrays take the reflected operators themselves (an object array
# comes back), so they are held on the forward operators only
CASES = [(op, operand) for op in sorted(OPS)
         for operand in ("scalar", "int", "array", "trial_array", "object")
         if not (op.startswith("r") and operand.endswith("array"))]


@pytest.mark.parametrize("op,operand", CASES)
def test_operator_matches_jax(op, operand):
    got = OPS[op](_analog(spt), _operands(operand, spt))
    want = OPS[op](_analog(spy), _operands(operand, spy))
    assert isinstance(got, spt.AnalogData)
    _assert_same(got, want)


@pytest.mark.parametrize("op", sorted(OPS))
def test_operator_with_selections_matches_jax(op):
    """In-place selections on both operands: the selected trials, channels
    and latency window take part, and labels follow the selection."""
    results = []
    for pkg in (spt, spy):
        a, b = _analog(pkg), _analog(pkg, seed=2)
        a.selectdata(trials=[3, 1], channel=[0, 2, 4], latency=[0.0, 0.2], inplace=True)
        b.selectdata(trials=[1, 3], channel=[1, 2, 3], latency=[0.0, 0.2], inplace=True)
        results.append(OPS[op](a, b))
    _assert_same(*results)


@pytest.mark.parametrize("op", ["add", "mul", "rtruediv", "pow"])
def test_operator_on_gapped_trials_and_complex_spectra_matches_jax(op):
    gapped = np.array([[0, 80, 0], [150, 230, -20], [300, 380, 0]], float)
    _assert_same(OPS[op](_analog(spt, trl=gapped), 1.5), OPS[op](_analog(spy, trl=gapped), 1.5))
    _assert_same(OPS[op](_spectral(spt), _spectral(spt, seed=4)),
                 OPS[op](_spectral(spy), _spectral(spy, seed=4)))


def _error_type(fn):
    with pytest.raises(Exception) as info:
        fn()
    return type(info.value).__name__


@pytest.mark.parametrize("case", ["zero", "type", "class", "trials", "shape", "broadcast"])
def test_operator_errors_match_jax(case):
    def call(pkg):
        a = _analog(pkg)
        if case == "zero":
            return a / 0
        if case == "type":
            return a + "x"
        if case == "class":
            return a + _spectral(pkg)
        if case == "trials":
            return a + _analog(pkg, trl=np.array([[0, 100, 0], [100, 200, 0]], float))
        if case == "shape":
            return a + _analog(pkg, trl=np.array([[0, 90, 0], [100, 200, 0], [200, 300, 0],
                                                  [300, 400, 0]], float))
        return a * np.ones(7)
    got, want = _error_type(lambda: call(spt)), _error_type(lambda: call(spy))
    assert got == want and got.startswith("SPY")


@pytest.mark.parametrize("dim", ["channel", "taper", "freq"])
def test_concat_matches_jax(dim):
    if dim == "channel":
        pair = {pkg: (_analog(pkg), _analog(pkg, seed=3)) for pkg in (spt, spy)}
    else:
        pair = {pkg: (_spectral(pkg), _spectral(pkg, seed=5)) for pkg in (spt, spy)}
    got = spt.concat(*pair[spt], dim=dim)
    want = spy.concat(*pair[spy], dim=dim)
    _assert_same(got, want)


def test_concat_of_channel_halves_gives_the_whole():
    whole = _analog(spt)
    first = whole.selectdata(channel=[0, 1])
    last = whole.selectdata(channel=[2, 3, 4])
    _assert_same(spt.concat(first, last, dim="channel"), whole)


def test_trial_halves_concatenate_to_the_whole():
    """Trials concatenate through the object-list constructor (concat
    joins along a non-stacking dimension)."""
    trl = np.column_stack([np.arange(4) * 100, np.arange(1, 5) * 100, np.zeros(4)])
    whole = _analog(spt, trl=trl)
    first, last = whole.selectdata(trials=[0, 1]), whole.selectdata(trials=[2, 3])
    joined = spt.AnalogData([first, last])
    _assert_same(joined, whole)
    jax_whole = _analog(spy, trl=trl)
    _assert_same(joined, spy.AnalogData([jax_whole.selectdata(trials=[0, 1]),
                                         jax_whole.selectdata(trials=[2, 3])]))


@pytest.mark.parametrize("case", ["class", "dim", "stacking", "shape"])
def test_concat_errors_match_jax(case):
    def call(pkg):
        a = _analog(pkg)
        if case == "class":
            return pkg.concat(a, _spectral(pkg))
        if case == "dim":
            return pkg.concat(a, a, dim="sth")
        if case == "stacking":
            return pkg.concat(a, a, dim="time")
        return pkg.concat(a, _analog(pkg, trl=np.array([[0, 90, 0], [100, 200, 0], [200, 300, 0],
                                                        [300, 400, 0]], float)))
    got, want = _error_type(lambda: call(spt)), _error_type(lambda: call(spy))
    assert got == want and got.startswith("SPY")


REDEFINE = {
    "trials": dict(trials=[2, 0]),
    "minlength": dict(minlength=0.35),
    "maxperlen": dict(minlength="maxperlen"),
    "offset": dict(offset=-20),
    "offsets": dict(trials=[0, 1], offset=[-5, 7]),
    "toilim": dict(toilim=[0.0, 0.2]),
    "samples": dict(begsample=10, endsample=60),
    "trl": dict(trl=np.array([[0, 50, 0], [50, 100, -10], [100, 400, 0]])),
}


@pytest.mark.parametrize("case", sorted(REDEFINE))
def test_redefinetrial_matches_jax(case):
    trl = np.array([[0, 100, -10], [100, 250, 0], [250, 400, 5]], float)
    got = spt.redefinetrial(_analog(spt, trl=trl), **REDEFINE[case])
    want = spy.redefinetrial(_analog(spy, trl=trl), **REDEFINE[case])
    _assert_same(got, want)


def test_redefinetrial_into_shorter_trials_is_numpy_slicing():
    whole = _analog(spt)
    data = np.asarray(whole.data)
    trl = np.column_stack([np.arange(8) * 50, np.arange(1, 9) * 50, np.zeros(8)])
    out = spt.redefinetrial(whole, trl=trl)
    for k in range(8):
        _bitwise(out.trials[k], data[50 * k:50 * (k + 1)])


@pytest.mark.parametrize("case", ["exclusive", "trl_mix", "minlength_mix", "trials", "minlength"])
def test_redefinetrial_errors_match_jax(case):
    kwargs = {"exclusive": dict(toilim=[0, 0.2], begsample=10),
              "trl_mix": dict(trl=[[0, 10, 0]], trials=[0]),
              "minlength_mix": dict(minlength=0.1, toilim=[0, 0.2]),
              "trials": dict(trials=[9]),
              "minlength": dict(minlength=-1.0)}[case]
    got = _error_type(lambda: spt.redefinetrial(_analog(spt), **kwargs))
    want = _error_type(lambda: spy.redefinetrial(_analog(spy), **kwargs))
    assert got == want and got.startswith("SPY")
