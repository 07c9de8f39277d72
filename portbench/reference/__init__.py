"""Plain float64 references, one file per method, named by each call's
``reference`` in a configuration. Each imports torch, numpy and scipy
only: nothing of the port, of JAX or of the JAX package.

Each exposes, where `args` are the keyword arguments of the call's
frontend:

- ``expected(payload, cfg, args, device)``: what the reference works out
  from one dataset (the host payload that the program was handed), once
  per dataset;
- ``check(got, want, cfg)``: ``{name: number}``, the numbers that decide
  ``correct`` for one of the program's results (`got`, the call's host
  result);
- ``control(payload, cfg, args, device)``: the result of the reference put
  in the program's place one precision lower, which ``check`` must fail;
- ``work(cfg, args, trials)``: ``{kind: shapes}``, the work of one call
  over `trials` trials that a roofline reader prices (e.g. ``"csd"``).
"""
