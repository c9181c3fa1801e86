"""The port's command line entry points, run as
``python -m video_coding_tpu_torch.cli.<name>``:

- ``model_cli``    — codec CLI: decode frame/header/log, encode frame/log
  by the golden model or, with ``--engine torch``, the sessions;
- ``simulate_cli`` — the accelerated paths in lockstep against the golden
  model;
- ``generate_cli`` — the PTX (or SASS) of the kernels a device graph runs;
- ``oyuv``         — YUV tools: play / convert / compare;
- ``dct_tool``     — fixed-point vs floating-point DCT accuracy.

Every subcommand that runs on a device takes ``--device`` (the card unless
``cpu`` is asked for).
"""
