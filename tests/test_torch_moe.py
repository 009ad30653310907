"""Port parity for the capacity-based top-k MoE (``models/layers.py``):
dispatch and combine bit for bit the JAX package's ``_dispatch_group`` /
``_combine_group`` (vmapped over groups, as ``apply_moe`` runs them) at f32
and bf16 with picks dropped past capacity; the top k of tied probabilities
in ``lax.top_k``'s order; ``apply_moe`` on carried weights against JAX's for
the shared-expert (DeepSeek-V3) and parallel-dense (Arctic) variants; the
rank by running count equal to the stable-sort rank under hypothesis.

Tolerances: dispatch, combine, the top-k indices and the capacity exactly;
``apply_moe``'s out within 1e-5 of its largest magnitude (the expert
products are f32 matmuls summed in another order by XLA and PyTorch), its
aux within 1e-6 relative.
"""
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.configs import get_config as j_get_config
from repro.models import layers as jl
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.models import layers as tl
from repro_torch.models.config import MoEConfig

DTYPES = {"float32": (np.float32, torch.float32),
          "bfloat16": (ml_dtypes.bfloat16, torch.bfloat16)}


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype == ml_dtypes.bfloat16 else a


def _to_torch(a):
    a = np.asarray(a)
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _to_numpy(t):
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def _picks(rng, g, t, k, e):
    """(G, T, K) distinct experts per token, as a top k gives them."""
    return np.stack([np.stack([rng.permutation(e)[:k] for _ in range(t)])
                     for _ in range(g)]).astype(np.int32)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("g,t,k,e,c", [(3, 16, 2, 4, 3),   # drops
                                       (2, 9, 3, 5, 8),    # none dropped
                                       (2, 1, 8, 256, 1)])  # a decode step
def test_dispatch_and_combine_bitwise(dtype, g, t, k, e, c):
    np_dt, t_dt = DTYPES[dtype]
    rng = np.random.default_rng(g * 100 + t)
    d = 24
    xt = rng.normal(size=(g, t, d)).astype(np_dt)
    topi = _picks(rng, g, t, k, e)
    topw = rng.random((g, t, k)).astype(np_dt)
    jbuf, jdest, jkeep = jax.vmap(
        lambda x, i, w: jl._dispatch_group(x, i, w, e, c, xt.dtype)
    )(jnp.asarray(xt), jnp.asarray(topi), jnp.asarray(topw))
    buf, dest, keep = tl._dispatch_group(_to_torch(xt),
                                         torch.from_numpy(topi).long(), e, c)
    assert buf.dtype == t_dt and tuple(buf.shape) == (g, e, c, d)
    np.testing.assert_array_equal(_bits(_to_numpy(buf)), _bits(jbuf))
    np.testing.assert_array_equal(dest.numpy(), np.asarray(jdest))
    np.testing.assert_array_equal(keep.numpy(), np.asarray(jkeep))
    if c < t * k / e:
        assert not keep.all()       # the case drops picks
    out_e = rng.normal(size=(g, e, c, d)).astype(np_dt)
    jout = jax.vmap(
        lambda o, de, ke, w: jl._combine_group(o, de, ke, w, t, d, xt.dtype)
    )(jnp.asarray(out_e), jdest, jkeep, jnp.asarray(topw))
    out = tl._combine_group(_to_torch(out_e), dest, keep, _to_torch(topw))
    assert out.dtype == t_dt
    np.testing.assert_array_equal(_bits(_to_numpy(out)), _bits(jout))


def _j_route(router, x, k):
    """JAX ``apply_moe``'s routing lines, verbatim."""
    logits = (x @ router.astype(x.dtype)).astype(jnp.float32)
    probs = jax.nn.softmax(logits, axis=-1)
    topw, topi = jax.lax.top_k(probs, k)
    topw = topw / jnp.sum(topw, axis=-1, keepdims=True)
    return probs, topw.astype(x.dtype), topi


def _port(moe):
    """The port's MoEConfig of the JAX package's (its port-only fields at
    their defaults)."""
    return MoEConfig(**dataclasses.asdict(moe))


def _tied_moe(dtype=np.float32):
    """A MoE config of 6 experts, top 3, whose router columns 1 = 4 and
    2 = 5: every token ties those pairs exactly."""
    cfg = j_get_config("deepseek-v3-671b", reduced=True)
    moe = dataclasses.replace(cfg.moe, num_experts=6, top_k=3,
                              capacity_factor=1.0)
    jp = jax.device_get(jl.init_moe(jax.random.PRNGKey(2), cfg.d_model, moe,
                                    jnp.dtype(dtype)))
    router = np.array(jp["router"])
    router[:, 4], router[:, 5] = router[:, 1], router[:, 2]
    jp["router"] = router
    return cfg, moe, jp


def test_top_k_ties_keep_the_lower_expert_first():
    cfg, moe, jp = _tied_moe()
    x = np.random.default_rng(5).normal(
        size=(2, 16, cfg.d_model)).astype(np.float32)
    jprobs, jw, ji = _j_route(jnp.asarray(jp["router"]), jnp.asarray(x),
                              moe.top_k)
    probs, w, i = tl.moe_route(params_from_jax(jp, device="cpu"),
                               torch.from_numpy(x), _port(moe))
    ji = np.asarray(ji)
    # the constructed ties do reach the top k, and a tied pair keeps its
    # lower expert first
    assert any(((ji == a) & np.roll(ji == b, -1, axis=-1)).any()
               for a, b in ((1, 4), (2, 5)))
    np.testing.assert_array_equal(i.numpy(), ji)
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=1e-6)
    np.testing.assert_allclose(probs.numpy(), np.asarray(jprobs), rtol=1e-6)


def test_apply_moe_with_ties_and_drops_matches_jax():
    """Tied router columns and capacity 1.0: which of two tied experts a
    token reaches, and which picks are dropped, decide the output."""
    cfg, moe, jp = _tied_moe()
    x = np.random.default_rng(6).normal(
        size=(2, 16, cfg.d_model)).astype(np.float32)
    jout, jaux = jl.apply_moe(jp, jnp.asarray(x), moe, "silu")
    out, aux = tl.apply_moe(params_from_jax(jp, device="cpu"),
                            torch.from_numpy(x), _port(moe), "silu")
    jout = np.asarray(jout)
    assert np.abs(out.numpy() - jout).max() <= 1e-5 * np.abs(jout).max()
    np.testing.assert_allclose(aux.item(), float(jaux), rtol=1e-6)


@pytest.mark.parametrize("arch,capacity", [("deepseek-v3-671b", 1.25),
                                           ("deepseek-v3-671b", 0.5),
                                           ("arctic-480b", 1.25)])
def test_apply_moe_matches_jax(arch, capacity):
    """The shared-expert (DeepSeek-V3) and the moe+dense (Arctic) variants
    at their reduced widths, on carried weights; capacity 0.5 drops half
    the picks."""
    cfg = j_get_config(arch, reduced=True)
    moe = dataclasses.replace(cfg.moe, capacity_factor=capacity)
    jp = jax.device_get(jl.init_moe(jax.random.PRNGKey(0), cfg.d_model, moe,
                                    jnp.float32, cfg.mlp_act))
    tp = params_from_jax(jp, device="cpu")
    assert set(tp) == set(jp) and tp["router"].dtype == torch.float32
    x = np.random.default_rng(1).normal(
        size=(3, 20, cfg.d_model)).astype(np.float32)
    jout, jaux = jl.apply_moe(jp, jnp.asarray(x), moe, cfg.mlp_act)
    t_moe = dataclasses.replace(get_config(arch, reduced=True).moe,
                                capacity_factor=capacity)
    out, aux = tl.apply_moe(tp, torch.from_numpy(x), t_moe, cfg.mlp_act)
    jout = np.asarray(jout)
    assert out.shape == jout.shape
    assert np.abs(out.numpy() - jout).max() <= 1e-5 * np.abs(jout).max()
    np.testing.assert_allclose(aux.item(), float(jaux), rtol=1e-6)
    assert tl.moe_capacity(20, moe) == max(1, int(np.ceil(
        20 * moe.top_k / moe.num_experts * capacity)))


def test_init_moe_tree_matches_jax():
    for arch in ("deepseek-v3-671b", "arctic-480b"):
        cfg = get_config(arch, reduced=True)
        jp = jax.eval_shape(lambda: jl.init_moe(
            jax.random.PRNGKey(0), cfg.d_model,
            j_get_config(arch, reduced=True).moe, jnp.bfloat16))
        tp = tl.init_moe(torch.Generator().manual_seed(0), cfg.d_model,
                         cfg.moe, torch.bfloat16)
        assert jax.tree.structure(jp) == jax.tree.structure(
            jax.tree.map(lambda a: 0, tp, is_leaf=torch.is_tensor))
        for a, b in zip(jax.tree.leaves(jp), jax.tree.leaves(
                tp, is_leaf=torch.is_tensor)):
            assert tuple(b.shape) == a.shape
            assert str(b.dtype)[6:] == str(a.dtype)


@settings(max_examples=60, deadline=None)
@given(st.integers(1, 3), st.integers(1, 12), st.integers(1, 4),
       st.integers(2, 9), st.integers(0, 2 ** 31 - 1))
def test_running_count_rank_is_the_stable_sort_rank(g, t, k, e, seed):
    """The dispatch's slot of every (token, k) pick equals its rank among
    the picks of its expert after a stable sort by expert (JAX's
    ``argsort`` / ``searchsorted``), repeats of an expert included."""
    rng = np.random.default_rng(seed)
    topi = rng.integers(0, e, (g, t, k)).astype(np.int32)
    c = t * k   # nothing dropped: dest reads the slot back
    _, dest, keep = tl._dispatch_group(torch.zeros(g, t, 1),
                                       torch.from_numpy(topi).long(), e, c)
    assert keep.all()
    slot = (dest - torch.from_numpy(topi).long() * c).reshape(g, t * k)
    for gi in range(g):
        flat = topi[gi].reshape(-1)
        order = np.argsort(flat, kind="stable")
        starts = np.searchsorted(flat[order], np.arange(e))
        want = np.empty(t * k, np.int64)
        want[order] = np.arange(t * k) - starts[flat[order]]
        np.testing.assert_array_equal(slot[gi].numpy(), want)
