"""The port's GPipe schedule (``parallel/pipeline.py``) on four CPU gloo
ranks against the JAX package's on four of its virtual CPU devices, and
against the port's sequential loop.

  * ``pipeline_apply`` on JAX's test body ``tanh(x @ W_i)``, 8 layers over
    4 stages, 6 microbatches: the output against JAX's, and the gradients
    of ``sum(out * cot)`` (weights and input) against ``jax.vjp`` of JAX's
    pipeline and against the sequential loop, under remat off and "full";
  * ``pipeline_blocks`` on an 8-block stack (dim 32, 2 heads, RoPE tables
    on a 2x2 grid), 2 microbatches of 2 rows: the output and the weights'
    gradients against JAX's at remat off (weights carried across with
    ``_blocks_out``),
    the output, the input's and the tables' gradients against the
    sequential ``run_blocks``;
  * the schedule's collectives (M + S - 2 shifts each way); a depth that
    does not divide the stages raises; ``maybe_pipeline_blocks`` refuses rows
    or a depth that do not divide, and ``run_blocks`` under a pipe axis then
    runs the sequential loop.

Gates: fp32 within 1e-5 abs of the sequential loop, 2e-5 of JAX's forward
(JAX's own gate for pipeline against scan), 5e-4 of JAX's gradients.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_dist import start_ranks
from tests.torch_parallel_workers import pipeline_cases
from vtp_tpu.convert.to_torch import _blocks_out
from vtp_tpu.models.blocks import BlockConfig as JaxBlockConfig
from vtp_tpu.models.blocks import init_stacked_blocks
from vtp_tpu.parallel.pipeline import make_pipeline_mesh, pipeline_apply, pipeline_blocks
from vtp_tpu_torch.ops.rope import rope_periods_init, rope_sincos

torch.set_num_threads(1)
WORLD, DEPTH = 4, 8
BLOCK = dict(dim=32, num_heads=2, ffn_ratio=2.0)
B, N, MICRO = 4, 4, 2


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    rng = np.random.default_rng(0)
    ws = (0.1 * rng.standard_normal((DEPTH, 16, 16))).astype(np.float32)
    x_lin = rng.standard_normal((6, 4, 16)).astype(np.float32)
    cot_lin = rng.standard_normal((6, 4, 16)).astype(np.float32)
    stack = init_stacked_blocks(jax.random.key(0), JaxBlockConfig(**BLOCK), DEPTH)
    sd = {}
    _blocks_out(sd, "b", stack, DEPTH)
    sd = {k[2:]: np.asarray(v, np.float32) for k, v in sd.items()}
    x_tok = rng.standard_normal((B, N, BLOCK["dim"])).astype(np.float32)
    cot_tok = rng.standard_normal((B, N, BLOCK["dim"])).astype(np.float32)
    rope = [t.numpy() for t in rope_sincos(rope_periods_init(16, dtype=torch.float32), 2, 2)]
    join = start_ranks(pipeline_cases, WORLD, tmp_path_factory.mktemp("pp"), ws, x_lin,
                       cot_lin, BLOCK, sd, x_tok, cot_tok, rope)
    return dict(ws=ws, x_lin=x_lin, cot_lin=cot_lin, stack=stack, x_tok=x_tok, cot_tok=cot_tok,
                rope=rope, join=join, mesh=make_pipeline_mesh(WORLD))


@pytest.fixture(scope="module")
def jax_linear(setup):
    """JAX's pipelined linear body and its vjp, at remat off and "full"."""
    s = setup
    body = lambda w, x: jnp.tanh(x @ w)
    out = {}
    for remat in (False, "full"):
        fn = lambda ws, x: pipeline_apply(body, ws, x, mesh=s["mesh"], remat=remat)
        o, pull = jax.vjp(fn, jnp.asarray(s["ws"]), jnp.asarray(s["x_lin"]))
        out[remat] = (o, *pull(jnp.asarray(s["cot_lin"])))
    return out


@pytest.fixture(scope="module")
def ranks(setup, jax_linear, jax_blocks):
    """The ranks' results, joined once JAX's references are computed (the
    ranks run meanwhile)."""
    return setup["join"]()


def _close(got, want, atol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= atol, np.abs(got - want).max()


@pytest.mark.parametrize("remat", [False, "full"])
def test_pipeline_apply_matches_jax_and_the_loop(ranks, jax_linear, remat):
    o, dws, dx = jax_linear[remat]
    seq = ranks[0]["linear_seq"]
    for rank in ranks:
        got = rank[f"linear_{remat}"]
        _close(got["o"], o, 2e-5)
        _close(got["o"], seq["o"], 1e-5)
        _close(got["dx"], dx, 5e-4)
        _close(got["dx"], seq["dx"], 1e-5)
        for i in range(DEPTH):
            _close(got["grads"][f"{i}.w"], dws[i], 5e-4)
            _close(got["grads"][f"{i}.w"], seq["grads"][f"{i}.w"], 1e-5)


@pytest.fixture(scope="module")
def jax_blocks(setup):
    """JAX's pipelined stack and the vjp of its weights (remat off: the
    policy changes what the backward keeps, not what it computes, and one
    compile of the remat arm would double this file's time)."""
    s = setup
    cfg = JaxBlockConfig(**BLOCK)
    shapes = [(B // MICRO, N)]
    rope = [tuple(jnp.asarray(t) for t in s["rope"])]

    def fn(stack, x):
        out = pipeline_blocks(x.reshape(MICRO, -1, BLOCK["dim"]), stack, cfg, rope, shapes,
                              mesh=s["mesh"])
        return out.reshape(x.shape)

    o, pull = jax.vjp(fn, s["stack"], jnp.asarray(s["x_tok"]))
    d_stack, _ = pull(jnp.asarray(s["cot_tok"]))
    want = {}
    _blocks_out(want, "b", d_stack, DEPTH)
    return o, want


@pytest.mark.parametrize("remat", [False, "full"])
def test_pipeline_blocks_matches_jax_and_the_loop(ranks, jax_blocks, remat):
    o, want = jax_blocks
    seq = ranks[0]["blocks_seq"]
    for rank in ranks:
        got = rank[f"blocks_{remat}"]
        _close(got["o"], o, 2e-5)
        _close(got["o"], seq["o"], 1e-5)
        _close(got["dx"], seq["dx"], 1e-5)
        for a, b in zip(got["drope"], seq["drope"]):
            _close(a, b, 1e-5)
        assert set(got["grads"]) == set(seq["grads"])
        for name, g in got["grads"].items():
            _close(g, np.asarray(want[f"b.{name}"], np.float32), 5e-4)
            _close(g, seq["grads"][name], 1e-5)


def test_schedule_collectives(ranks):
    """One pipelined call under grad (6 microbatches, 4 stages) shifts M + S
    - 2 = 8 times forward and 8 times backward, on every rank."""
    for rank in ranks:
        for remat in (False, "full"):
            assert rank[f"linear_{remat}"]["calls"] == {"ppermute": 16}


def test_depth_must_divide_and_unsupported_layouts_fall_back(ranks):
    """A depth that does not divide the stages raises ``ValueError``;
    ``maybe_pipeline_blocks`` returns None for rows or a depth that do not
    divide, and ``run_blocks`` under a pipe axis then gives the sequential
    loop's result."""
    for rank in ranks:
        assert "must divide" in rank["depth_error"]
        assert rank["fallback_rows"] is None and rank["fallback_depth"] is None
        np.testing.assert_array_equal(rank["fallback_seq"], rank["fallback_seq_want"])
