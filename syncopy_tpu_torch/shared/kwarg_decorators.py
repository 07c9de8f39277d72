# -*- coding: utf-8 -*-
#
# Frontend decorators: @unwrap_cfg, @unwrap_select, @detect_parallel_client.
#
# Parity target: reference syncopy/shared/kwarg_decorators.py:32-584.
# The @process_io worker wrapper (reference :587-739) has no analog here —
# host/device staging is done inside the engine, not per-worker.

import functools

from .errors import SPYError, SPYTypeError, SPYValueError
from .profiling import span
from .tools import StructDict

__all__ = ["unwrap_cfg", "unwrap_select", "detect_parallel_client"]


def unwrap_cfg(func):
    """
    Support FieldTrip-style ``cfg`` call conventions:

    - ``func(cfg)`` / ``func(cfg, data)`` / ``func(data, cfg)`` /
      ``func(data, cfg=cfg)``: entries of `cfg` become keyword arguments.
    - ``cfg.data``/``cfg.dataset`` may carry the input object itself.
    - replaying a stored ``out.cfg`` (nested ``{funcname: {...}}``) works.

    Reference kwarg_decorators.py:32-299.
    """

    name = "spt." + func.__name__  # the frontend's span (shared/profiling.py)

    @functools.wraps(func)
    def wrapper_cfg(*args, **kwargs):
        with span(name):
            cfg = None
            args = list(args)

            # cfg passed as kwarg
            if "cfg" in kwargs:
                cfg = kwargs.pop("cfg")
                if not isinstance(cfg, dict):
                    raise SPYTypeError(cfg, varname="cfg", expected="dict or StructDict")

            # cfg passed positionally (either slot); more than one dict — or a
            # positional dict on top of a cfg keyword — is ambiguous
            dict_pos = [k for k, a in enumerate(args)
                        if isinstance(a, dict) and not hasattr(a, "dimord")]
            if dict_pos and (cfg is not None or len(dict_pos) > 1):
                raise SPYValueError(
                    legal="single `cfg` argument", varname="cfg", actual="two cfg dicts"
                )
            if dict_pos:
                cfg = args.pop(dict_pos[0])

            if cfg is not None:
                cfg = StructDict(cfg)

                # replay nested out.cfg: {funcname: {...}, otherfunc: {...}}
                if func.__name__ in cfg and isinstance(cfg[func.__name__], dict):
                    cfg = StructDict(cfg[func.__name__])

                cfg = StructDict({k: v for k, v in cfg.items()})

                # linguistic booleans
                for key, value in list(cfg.items()):
                    if isinstance(value, str):
                        if value.lower() == "yes":
                            cfg[key] = True
                        elif value.lower() == "no":
                            cfg[key] = False

                # data may live inside cfg
                data_from_cfg = None
                for dkey in ("data", "dataset"):
                    if dkey in cfg:
                        data_from_cfg = cfg.pop(dkey)
                if data_from_cfg is not None:
                    if args:
                        raise SPYValueError(
                            legal="data passed either positionally or via cfg, not both",
                            varname="cfg.data",
                        )
                    args = [data_from_cfg]

                for key, value in cfg.items():
                    if key in kwargs:
                        raise SPYValueError(
                            legal="non-conflicting cfg entries",
                            varname=key,
                            actual="set in both cfg and kwargs",
                        )
                    kwargs[key] = value

            return func(*args, **kwargs)

    _amend_docstring_and_signature(func, wrapper_cfg)
    return wrapper_cfg


def _amend_docstring_and_signature(func, wrapper):
    """Advertise the ``cfg`` calling convention on the wrapped frontend:
    append a usage note to the docstring and add a ``cfg=None`` keyword to
    the exposed signature (reference kwarg_decorators.py:200-299 performs
    the same amendment so `help(frontend)` documents cfg support)."""
    import inspect

    note = (
        "\n\n    Notes\n    -----\n"
        "    This function supports FieldTrip-style ``cfg`` usage: collect\n"
        "    all options in a config dict/StructDict and call\n"
        "    ``{name}(cfg)`` (with ``cfg.data`` / ``cfg.dataset`` set) or\n"
        "    ``{name}(data, cfg)``. Entries of ``cfg`` become keyword\n"
        "    arguments; a stored ``out.cfg`` can be passed back to replay\n"
        "    an analysis.\n"
    ).format(name=func.__name__)
    if wrapper.__doc__:
        wrapper.__doc__ = wrapper.__doc__.rstrip() + note
    else:
        wrapper.__doc__ = note.lstrip()
    try:
        sig = inspect.signature(func)
        if "cfg" not in sig.parameters:
            params = [
                p for p in sig.parameters.values()
                if p.kind is not inspect.Parameter.VAR_KEYWORD
            ]
            var_kw = [
                p for p in sig.parameters.values()
                if p.kind is inspect.Parameter.VAR_KEYWORD
            ]
            params.append(
                inspect.Parameter("cfg", inspect.Parameter.KEYWORD_ONLY, default=None)
            )
            wrapper.__signature__ = sig.replace(parameters=params + var_kw)
    except (ValueError, TypeError):
        pass


def unwrap_select(func):
    """
    Pop the ``select`` keyword, apply it as a transient in-place selection on
    the input object, run `func`, and restore the prior selection state.

    Reference kwarg_decorators.py:302-412.
    """

    @functools.wraps(func)
    def wrapper_select(*args, **kwargs):
        select = kwargs.get("select", None)
        data = args[0] if args else kwargs.get("data")
        prior = None
        applied = False
        if select is not None:
            if data is None or not hasattr(data, "selection"):
                raise SPYError("`select` requires a syncopy_tpu data object as input")
            prior = data._selection
            data.selection = select
            applied = True
            # leave `select` in kwargs: frontends record it into out.cfg
            # (reference get_frontend_cfg pops it there, tools.py:205-213)
        elif "select" in kwargs:
            kwargs.pop("select")
        try:
            return func(*args, **kwargs)
        finally:
            if applied:
                data._selection = prior

    return wrapper_select


def detect_parallel_client(func):
    """
    Validate the ``parallel`` keyword at the frontend boundary; the
    frontend passes it on to the engine, where
    :func:`~syncopy_tpu_torch.parallel.mesh.resolve_parallel` maps it to a
    mesh: ``None`` picks up the process-global active mesh (the analog of
    the reference detecting a running Dask client), ``True`` builds a mesh
    over all visible devices (warns and runs on one device when only one
    exists), ``False`` forces one device. An active mesh that the call
    would use is checked here already (:func:`~syncopy_tpu_torch.parallel.
    mesh.check_mesh`), before any work.

    Reference kwarg_decorators.py:415-584.
    """

    @functools.wraps(func)
    def wrapper_parallel(*args, **kwargs):
        from ..parallel.mesh import active_mesh, check_mesh

        parallel = kwargs.get("parallel", None)
        if parallel not in (None, True, False):
            raise SPYValueError(
                legal="`parallel` to be None, True or False", varname="parallel", actual=str(parallel)
            )
        if parallel is not False and active_mesh() is not None:
            check_mesh(active_mesh())
        return func(*args, **kwargs)

    return wrapper_parallel
