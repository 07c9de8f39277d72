# -*- coding: utf-8 -*-
# The engine's log text (engine/routine.py::write_log, _log_text): a plain
# numeric ndarray that numpy prints in full is printed once per distinct
# content and print options, and its stored text is reused; every other
# value is printed by str(). Each case holds the text to str() of the same
# value, and log_format_counts() to the route it took. Two coherence calls
# on the CPU print the frequency axis once, and their logs equal each other
# and the log built with plain str(), apart from the time of the entry.

import re
import sys

import numpy as np
import pytest
import torch

import syncopy_tpu_torch as spt
from syncopy_tpu_torch.engine import routine

torch.set_num_threads(1)

FS = 1000.0


@pytest.fixture(autouse=True)
def _fresh_log_text(monkeypatch):
    previous = spt.set_device("cpu")
    routine.clear_device_cache()
    monkeypatch.setattr(routine, "_LOG_TEXT", {})
    routine.reset_log_format_counts()
    yield
    routine.clear_device_cache()
    spt.set_device(previous)


def _rng():
    return np.random.default_rng(24)


def _masked():
    return np.ma.masked_array([1.0, 2.0, 3.0], mask=[0, 1, 0])


VALUES = {
    "foi_501": (lambda: np.linspace(0.0, 500.0, 501), "formatted"),
    "float32": (lambda: _rng().normal(size=37).astype(np.float32), "formatted"),
    "int": (lambda: np.arange(-5, 20), "formatted"),
    "uint8": (lambda: np.arange(250, 256, dtype=np.uint8), "formatted"),
    "complex": (lambda: _rng().normal(size=8) + 1j * _rng().normal(size=8), "formatted"),
    "bool": (lambda: np.array([True, False, True]), "formatted"),
    "zero_d": (lambda: np.array(3.25), "formatted"),
    "empty": (lambda: np.array([]), "formatted"),
    "two_d": (lambda: _rng().normal(size=(4, 5)), "formatted"),
    "strided_view": (lambda: _rng().normal(size=(6, 8))[::2, 1::3], "formatted"),
    "transposed": (lambda: np.arange(12.0).reshape(3, 4).T, "formatted"),
    "nan_inf": (lambda: np.array([1.0, np.nan, np.inf, -np.inf, -0.0]), "formatted"),
    "masked": (_masked, "direct"),
    "strings": (lambda: np.array(["hann", "dpss"]), "direct"),
    "objects": (lambda: np.array([{"a": 1}, None], dtype=object), "direct"),
    "above_threshold": (lambda: np.zeros(1001), "direct"),
    "list": (lambda: [1, 2.5, "x"], "direct"),
    "string": (lambda: "dpss", "direct"),
    "none": (lambda: None, "direct"),
    "scalar": (lambda: np.float64(0.1), "direct"),
}


@pytest.mark.parametrize("case", list(VALUES))
def test_log_text_equals_str(case):
    make, first = VALUES[case]
    v = make()
    assert routine._log_text(v) == str(v)
    # a new value of equal content, then the same one again
    assert routine._log_text(make()) == str(v)
    assert routine._log_text(v) == str(v)
    again = "cached" if first == "formatted" else "direct"
    want = {"cached": 0, "formatted": 0, "direct": 0}
    want[first] += 1
    want[again] += 2
    assert routine.log_format_counts() == want


def test_print_options_are_part_of_the_key():
    v = _rng().normal(size=20)
    plain = routine._log_text(v)
    assert plain == str(v)
    with np.printoptions(precision=3):
        short = routine._log_text(v)
        assert short == str(v)
    assert short != plain
    assert routine._log_text(v) == str(v) == plain
    assert routine.log_format_counts() == {"cached": 1, "formatted": 2, "direct": 0}


def test_a_custom_formatter_or_a_low_threshold_prints_directly():
    v = np.arange(10.0)
    with np.printoptions(formatter={"float": lambda x: "<{:.1f}>".format(x)}):
        assert routine._log_text(v) == str(v)
        assert "<9.0>" in str(v)
    with np.printoptions(threshold=5):
        assert routine._log_text(v) == str(v)
        assert "..." in str(v)
    assert routine.log_format_counts() == {"cached": 0, "formatted": 0, "direct": 2}


def test_an_array_changed_in_place_gives_its_new_text():
    v = np.arange(5.0)
    before = routine._log_text(v)
    v[2] = 7.5
    after = routine._log_text(v)
    assert after == str(v) != before
    assert routine.log_format_counts() == {"cached": 0, "formatted": 2, "direct": 0}


def test_equal_bytes_of_another_dtype_or_shape_give_their_own_text():
    values = [np.zeros(4), np.zeros(4, dtype=np.int64), np.zeros((2, 2)), np.zeros(8, np.float32)]
    assert len({v.tobytes() for v in values}) == 1
    for v in values + values:
        assert routine._log_text(v) == str(v)
    assert routine.log_format_counts() == {"cached": 4, "formatted": 4, "direct": 0}


def test_the_store_is_bounded():
    big = np.zeros(routine._LOG_TEXT_SIZE + 1)
    with np.printoptions(threshold=sys.maxsize):
        assert routine._log_text(big) == str(big)
    assert routine.log_format_counts()["direct"] == 1
    for i in range(3 * routine._LOG_TEXT_ENTRIES):
        v = np.full(3, float(i))
        assert routine._log_text(v) == str(v)
    assert len(routine._LOG_TEXT) == routine._LOG_TEXT_ENTRIES
    assert all(len(key[2]) <= 16 * routine._LOG_TEXT_SIZE for key in routine._LOG_TEXT)


_ENTRY_HEADER = re.compile(r"^\|=== .*: \d{4}-\d\d-\d\d \d\d:\d\d:\d\d ===\|$")


def _without_time(log):
    return [("<entry>" if _ENTRY_HEADER.match(line) else line) for line in log.splitlines()]


def test_two_coherence_calls_print_the_frequency_axis_once(monkeypatch):
    rng = np.random.default_rng(7)
    data = spt.from_arrays(rng.normal(size=(12 * 200, 3)).astype(np.float32),
                           np.array([[200 * i, 200 * (i + 1), 0] for i in range(12)]), FS)
    logs, counts = [], []
    for _ in range(2):
        routine.reset_log_format_counts()
        out = spt.connectivityanalysis(data, method="coh", tapsmofrq=2)
        logs.append(out.log)
        counts.append(routine.log_format_counts())
    assert out.freq.size == 101
    assert (counts[0]["formatted"], counts[0]["cached"]) == (1, 0)
    assert (counts[1]["formatted"], counts[1]["cached"]) == (0, 1)
    assert counts[0]["direct"] == counts[1]["direct"] > 0

    monkeypatch.setattr(routine, "_log_text", str)
    plain = spt.connectivityanalysis(data, method="coh", tapsmofrq=2).log
    assert "foi" in plain and str(out.freq) in plain
    assert _without_time(logs[0]) == _without_time(logs[1]) == _without_time(plain)
    assert sum(line == "<entry>" for line in _without_time(plain)) >= 1
