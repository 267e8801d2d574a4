"""Command-line tools of the port, run as ``python -m vtp_tpu_torch.tools.<name>``:
``compute_fid``, ``eval_reconstruction`` and ``eval_zero_shot`` (the JAX
package's ``tools/`` CLIs, on ``cuda`` unless ``--device cpu``)."""
