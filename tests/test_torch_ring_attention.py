"""The port's context-parallel attention (``ops/ring_attention.py``) on CPU
gloo ranks against the JAX package's arms on its virtual CPU devices.

Inputs are seeded numpy arrays, (B, N, H, d) = (2, 16, 8, 8). Each rank
runs the ring or Ulysses on its token shard (under CP x TP, a (1, 2, 2)
mesh of four ranks, on its token and head shard); the shards are gathered
and held against ``ring_attention_bnhd`` / ``ulysses_attention_bnhd`` on a
JAX ``seq`` mesh of the same size, forward and gradients (the vjp of a
seeded cotangent), at world sizes 2 and 4, with and without ``n_valid``
(11 of 16 masks rank 3's whole key block at world size 4). Gates: fp32
within 1e-5 abs (JAX's own), bf16 within 5e-2 of max|ref| of the fp32
attention of the same bf16 inputs. Also: the hop counts (the forward's S -
1 K/V hops, the backward's S - 1 K/V and S dK/dV hops: the dead final K/V
rotation is skipped), ``sdpa_bnhd``'s arm under each mode, the gates and
the eager entry.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_dist import start_ranks
from tests.torch_parallel_workers import cp_attention_cases
from vtp_tpu.ops.ring_attention import ring_attention as jax_ring_attention
from vtp_tpu.ops.ring_attention import ring_attention_bnhd, ulysses_attention_bnhd
from vtp_tpu.parallel.mesh import make_cp_mesh
from vtp_tpu_torch.ops.ring_attention import ring_supported, ulysses_supported
from vtp_tpu_torch.parallel.mesh import AxisGroup

torch.set_num_threads(1)
B, N, H, D = 2, 16, 8, 8
N_VALID = 11
F32_ABS, BF16_REL = 1e-5, 5e-2
JAX_ARMS = {"ring": ring_attention_bnhd, "ulysses": ulysses_attention_bnhd}


def _inputs(seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, N, H, D)).astype(np.float32) for _ in range(4)]


def _cases(world):
    """(name, arm, q, k, v, cotangent, n_valid, dtype) of one world size."""
    out = []
    arms = [("ring", 0, "float32"), ("ring", N_VALID, "float32"), ("ulysses", 0, "float32"),
            ("ulysses", N_VALID, "float32"), ("ring", N_VALID, "bfloat16"),
            ("ulysses", 0, "bfloat16")]
    for i, (arm, n_valid, dtype) in enumerate(arms):
        out.append((f"{arm}_{n_valid}_{dtype}", arm, *_inputs(100 * world + i), n_valid, dtype))
    return out


CP_TP = [("cp_tp_ring", "ring", *_inputs(7), N_VALID, "float32"),
         ("cp_tp_ulysses", "ulysses", *_inputs(8), 0, "float32")]


def _plain(q, k, v, n_valid=0):
    s = jnp.einsum("bqhd,bkhd->bhqk", q, k) * D ** -0.5
    if n_valid:
        s = jnp.where(jnp.arange(q.shape[1]) < n_valid, s, -jnp.inf)
    return jnp.einsum("bhqk,bkhd->bqhd", jax.nn.softmax(s, -1), v)


def _vjp(fn, q, k, v, w):
    o, pull = jax.vjp(fn, *(jnp.asarray(t) for t in (q, k, v)))
    return np.asarray(o), [np.asarray(g) for g in pull(jnp.asarray(w))]


def _jax_arm(arm, n_seq, n_model, n_valid, q, k, v, w):
    mesh = make_cp_mesh(n_seq, 1, n_model, devices=jax.devices()[:n_seq * n_model])
    fn = jax.jit(functools.partial(JAX_ARMS[arm], mesh=mesh, n_valid=n_valid))
    return _vjp(fn, q, k, v, w)


def _bf16(x):
    return np.asarray(torch.from_numpy(x).bfloat16().float())


def _arm_want(world, case):
    """The JAX arm on a seq mesh of ``world`` devices (fp32) or the plain
    attention of the same bf16 inputs (bf16): output and q/k/v gradients."""
    name, arm, q, k, v, w, n_valid, dtype = _cases(world)[case]
    if dtype == "float32":
        return _jax_arm(arm, world, 1, n_valid, q, k, v, w)
    return _vjp(functools.partial(_plain, n_valid=n_valid), *(_bf16(t) for t in (q, k, v)), w)


def _eager_want(world):
    _, _, q, k, v, w, _, _ = _cases(world)[1]
    mesh = make_cp_mesh(world, devices=jax.devices()[:world])
    return _vjp(lambda *a: jax_ring_attention(*a, mesh=mesh, n_valid=N_VALID), q, k, v, w)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every rank's results at world sizes 2 and 4 and JAX's references,
    computed while the ranks run."""
    joins = {world: start_ranks(cp_attention_cases, world, tmp_path_factory.mktemp(f"cp{world}"),
                                _cases(world), CP_TP if world == 4 else None)
             for world in (2, 4)}
    want = {("arm", world, case): _arm_want(world, case) for world in (2, 4) for case in range(6)}
    want.update({("cp_tp", case): _jax_arm(c[1], 2, 2, c[6], *c[2:6])
                 for case, c in enumerate(CP_TP)})
    want.update({("eager", world): _eager_want(world) for world in (2, 4)})
    return {world: join() for world, join in joins.items()}, want


def _close(got, want, gate):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    limit = F32_ABS if gate == "float32" else BF16_REL * np.abs(want).max()
    assert err <= limit, (err, limit)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("case", range(6))
def test_arm_matches_jax(runs, world, case):
    """Every rank's output and q/k/v gradients, gathered, against the JAX
    arm on a seq mesh of the same size (fp32) or the plain attention of the
    same bf16 inputs (bf16); every rank gathers the same."""
    name, dtype = _cases(world)[case][0], _cases(world)[case][7]
    want_o, want_g = runs[1][("arm", world, case)]
    for rank in runs[0][world]:
        got = rank[name]
        _close(got["o"], want_o, dtype)
        for g, wg in zip(got["grads"], want_g):
            _close(g, wg, dtype)


@pytest.mark.parametrize("case", range(2))
def test_cp_tp_matches_jax(runs, case):
    """CP x TP on a (1, 2, 2) mesh: each rank holds N/2 tokens of H/2 heads;
    the ring or Ulysses over its seq group against JAX's arm on a (1, 2, 2)
    ``make_cp_mesh``, forward and gradients."""
    name = CP_TP[case][0]
    want_o, want_g = runs[1][("cp_tp", case)]
    for rank in runs[0][4]:
        _close(rank[name]["o"], want_o, "float32")
        for g, wg in zip(rank[name]["grads"], want_g):
            _close(g, wg, "float32")


@pytest.mark.parametrize("world", [2, 4])
def test_hops_skip_the_dead_rotation(runs, world):
    """The ring's forward makes S - 1 K/V hops (one ``ppermute`` of the
    stacked K and V a hop); its backward S - 1 K/V hops and S dK/dV hops,
    2 S - 1 in all (the JAX scan's would be S and 2 S). Ulysses makes 4
    all-to-alls each way (q, k, v and the output) and no hop."""
    for rank in runs[0][world]:
        ring = rank[f"ring_{N_VALID}_float32"]
        assert ring["forward_calls"] == {"ppermute": world - 1}
        assert ring["backward_calls"] == {"ppermute": 2 * world - 1}
        uly = rank["ulysses_0_float32"]
        assert uly["forward_calls"] == {"all_to_all": 4}  # q, k, v and the output
        assert uly["backward_calls"] == {"all_to_all": 4}


@pytest.mark.parametrize("world", [2, 4])
def test_sdpa_bnhd_mode_rule(runs, world):
    """``sdpa_bnhd`` under a ``ContextParallel``: "auto" takes Ulysses where
    the heads divide the axis and the ring where they do not; "ring" always
    the ring; "ulysses" Ulysses, or where the heads do not divide, the
    rank's queries against the gathered keys and values (JAX's local
    attention). Each route within 1e-5 of the plain attention."""
    name, _, q, k, v, w, n_valid, _ = _cases(world)[0]
    want = {"ulysses": "all_to_all", "ring": "ppermute", "gathered": "gather_with_grad"}
    for heads in (world, world + 1):
        sl = [np.ascontiguousarray(t[:, :, :heads]) for t in (q, k, v, w)]
        want_o, want_g = _vjp(functools.partial(_plain, n_valid=n_valid), *sl)
        routes = {"auto": "ulysses" if heads == world else "ring", "ring": "ring",
                  "ulysses": "ulysses" if heads == world else "gathered"}
        for mode, route in routes.items():
            for rank in runs[0][world]:
                got = rank["routes"][f"route_{mode}_{heads}"]
                assert set(got["forward_calls"]) == {want[route]}, (mode, heads, got)
                _close(got["o"], want_o, "float32")
                for g, wg in zip(got["grads"], want_g):
                    _close(g, wg, "float32")


@pytest.mark.parametrize("world", [2, 4])
def test_eager_entry_matches_jax(runs, world):
    """``ring_attention`` on whole tensors every rank holds: every rank
    returns JAX ``ring_attention``'s output and its gradients (a token dim
    that does not divide raises ``ValueError``)."""
    want_o, want_g = runs[1][("eager", world)]
    for rank in runs[0][world]:
        _close(rank["eager"]["o"], want_o, "float32")
        for g, wg in zip(rank["eager"]["grads"], want_g):
            _close(g, wg, "float32")
        assert "must divide" in rank["eager_error"]


def test_gates():
    """``ring_supported`` / ``ulysses_supported`` on a rank's local shapes:
    an axis of more than one rank, 0 <= n_valid <= the global tokens, and
    for Ulysses the rank's heads dividing the axis (JAX's other
    divisibility conditions hold by construction of the shards)."""
    q = torch.zeros(2, 4, 6, 8)  # 4 local tokens, 6 heads
    two, three, one = (AxisGroup("seq", None, n, 0) for n in (2, 3, 1))
    assert ring_supported(q, two) and ring_supported(q, two, 8) and ring_supported(q, two, 1)
    assert not ring_supported(q, None) and not ring_supported(q, one)
    assert not ring_supported(q, two, 9) and not ring_supported(q, two, -1)
    assert ulysses_supported(q, two) and ulysses_supported(q, three)
    assert not ulysses_supported(torch.zeros(2, 4, 3, 8), two)
    assert not ulysses_supported(q, two, 9) and not ulysses_supported(q, one)
