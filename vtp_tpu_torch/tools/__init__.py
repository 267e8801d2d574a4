"""Command-line tools of the port, run as ``python -m vtp_tpu_torch.tools.<name>``:
``compute_fid``, ``eval_reconstruction``, ``eval_zero_shot``,
``eval_linear_probing`` and ``validate_release`` (the JAX package's
``tools/`` CLIs, on ``cuda`` unless ``--device cpu``)."""
