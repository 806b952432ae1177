"""Context-parallel decode attention on the CPU: the port's
``partial_attention`` and ``combine_partials`` against the reference's (f32,
1e-5; a window, GQA and a fully masked shard), and ``cp_decode_attention``
over gloo worlds of 1 (in process), 2 and 4 ranks (spawned once for the
file, a ``FileStore`` under the test's temporary directory, a timeout on
every join) against the reference's unsharded ``decode_attention``.

``spawn_worlds`` and ``local_world`` (``tests/_gloo_worlds.py``) are shared
with ``tests/test_torch_moe_ep.py`` and ``tests/test_torch_sharded_state.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as jl
from repro.serve import context_parallel as jcp

from repro_torch.serve import context_parallel as cp

from _gloo_worlds import local_world, spawn_worlds

F32 = dict(rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# the math


def qkv(B=2, H=8, K=2, S=48, hd=16, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, 1, H, hd)).astype(np.float32),
            rng.standard_normal((B, S, K, hd)).astype(np.float32),
            rng.standard_normal((B, S, K, hd)).astype(np.float32))


@pytest.mark.parametrize("window", [0, 10])
@pytest.mark.parametrize("H,K", [(8, 2), (4, 4)])
@pytest.mark.parametrize("offset,q_position", [(0, 30), (24, 40), (24, 5)])
def test_partial_attention_matches_the_reference(window, H, K, offset,
                                                 q_position):
    """One shard's (m, l, acc) at kv positions offset..offset+23 (the last
    case: every position past the query, a fully masked shard)."""
    q, k, v = qkv(H=H, K=K, S=24)
    kv_pos = offset + np.arange(24)
    got = cp.partial_attention(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), torch.from_numpy(kv_pos),
                               q_position, window)
    want = jcp.partial_attention(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), jnp.asarray(kv_pos),
                                 q_position, window)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **F32)
    if offset > q_position:
        assert np.all(got[0].numpy() == cp.NEG)


def shard_partials(q, k, v, q_position, window, n, fn):
    S_loc = k.shape[1] // n
    return [fn(q, k[:, i * S_loc:(i + 1) * S_loc],
               v[:, i * S_loc:(i + 1) * S_loc],
               i * S_loc + np.arange(S_loc), q_position, window)
            for i in range(n)]


@pytest.mark.parametrize("window", [0, 12])
@pytest.mark.parametrize("q_position", [47, 3])
def test_combine_partials_matches_the_reference(window, q_position):
    """4 shards combined: equal to the reference's combine and to one-shard
    attention; q_position 3 leaves 3 shards fully masked, and no NaN."""
    q, k, v = qkv()
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    parts = shard_partials(
        tq, tk, tv, q_position, window, 4,
        lambda q, k, v, p, qp, w: cp.partial_attention(
            q, k, v, torch.from_numpy(p), qp, w))
    jparts = shard_partials(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), q_position, window,
        4, jcp.partial_attention)
    got = cp.combine_partials(*(torch.stack([p[i] for p in parts])
                                for i in range(3)))
    want = jcp.combine_partials(*(jnp.stack([p[i] for p in jparts])
                                  for i in range(3)))
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    one = cp.combine_partials(*(x[None] for x in cp.partial_attention(
        tq, tk, tv, torch.arange(48), q_position, window)))
    np.testing.assert_allclose(got.numpy(), one.numpy(), **F32)


# ---------------------------------------------------------------------------
# cp_decode_attention over gloo worlds

CASES = [dict(q_position=47, window=0), dict(q_position=20, window=0),
         dict(q_position=3, window=0), dict(q_position=40, window=9)]


def cp_job(rank, n, group, payload):
    """Every case on this rank's slice of the cache."""
    q, k, v = payload["q"], payload["k"], payload["v"]
    S_loc = k.shape[1] // n
    sl = slice(rank * S_loc, (rank + 1) * S_loc)
    out = {}
    for i, c in enumerate(payload["cases"]):
        o = cp.cp_decode_attention(
            torch.from_numpy(q), torch.from_numpy(k[:, sl].copy()),
            torch.from_numpy(v[:, sl].copy()), c["q_position"], group,
            window=c["window"])
        out[f"case{i}"] = o.numpy()
    return out


@pytest.fixture(scope="module")
def cp_worlds(tmp_path_factory):
    q, k, v = qkv()
    payload = dict(q=q, k=k, v=v, cases=CASES)
    tmp = str(tmp_path_factory.mktemp("cp"))
    got = spawn_worlds((2, 4), tmp, cp_job, payload)
    got[1] = local_world(cp_job, payload)
    want = {f"case{i}": np.asarray(jl.decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), c["q_position"],
        window=c["window"])) for i, c in enumerate(CASES)}
    return got, want


@pytest.mark.parametrize("n", [1, 2, 4])
@pytest.mark.parametrize("case", range(len(CASES)))
def test_cp_decode_attention_matches_unsharded(cp_worlds, n, case):
    """q_position 3 on 4 ranks of 12 positions: three fully masked
    shards."""
    got, want = cp_worlds
    g = got[n][f"case{case}"]
    assert g.shape == (2, 1, 8, 16) and np.isfinite(g).all()
    np.testing.assert_allclose(g, want[f"case{case}"], **F32)


def test_cp_decode_attention_reads_a_dtensor_shard():
    """A DTensor cache sharded on S is read through ``to_local()``."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    q, k, v = qkv()

    def job(rank, n, group, payload):
        m = init_device_mesh("cpu", (1,), mesh_dim_names=("data",))
        dk = distribute_tensor(torch.from_numpy(k), m, [Shard(1)])
        dv = distribute_tensor(torch.from_numpy(v), m, [Shard(1)])
        dq = distribute_tensor(torch.from_numpy(q), m, [Replicate()])
        return cp.cp_decode_attention(dq, dk, dv, 30, group).numpy()

    got = local_world(job, None)
    want = jl.decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               30)
    np.testing.assert_allclose(got, np.asarray(want), **F32)
