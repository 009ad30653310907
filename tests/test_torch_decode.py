"""Port parity for decode against the caches: the port's decode loop
against its own full-sequence forward (every mixer family: GQA, MLA, SSD,
RG-LRU beside local attention, dense and ring caches), each
``decode_step`` against the JAX package's on carried weights and a carried
mid-stream cache whose slots sit at staggered positions, ``prefill``
against JAX's, the cache helpers exactly JAX's, MLA's cache compressed and
SSD's of constant size.

A MoE's capacity is raised to 8 for decode against the forward, as the JAX
package's ``test_decode.py`` raises it: at capacity 1.25 the forward drops
picks that a one-token step keeps.

Tolerances, relative to the largest magnitude of the tensor compared
(max|port - ref| <= tol * max|ref|):
  * decode logits vs the same model's forward: 2e-4 (the JAX package's
    ``test_decode.py`` tolerance: the S == 1 grouped einsum and the
    full-sequence einsum sum in other orders);
  * port vs JAX, one ``decode_step`` or ``prefill``: logits 1e-5, cached
    k / v 1e-5 (the same f32 matmuls and einsums summed in another order
    by XLA and PyTorch); ``slot_pos`` exactly.
bf16 is held bit for bit where the computation is a copy or a select
(``_update_slot``, the caches' dtypes, ``convert``), as the LM tests hold
no bf16 model output bit for bit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import Model as JModel
from repro.models import attention as jatt
from repro_torch.configs import get_config
from repro_torch.convert import (caches_from_jax, caches_to_numpy,
                                 params_from_jax)
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.models import attention as tatt
from repro_torch.models.transformer import Model

B, S = 2, 32
DECODE_TOL = 2e-4   # decode vs forward (the JAX package's)
STEP_TOL = 1e-5     # port vs JAX, logits and k / v
ARCHS = ["nano-lm", "qwen3-0.6b", "glm4-9b", "musicgen-medium",
         "deepseek-v3-671b", "arctic-480b", "mamba2-780m",
         "recurrentgemma-9b"]


def _uncapped(cfg):
    if cfg.moe is not None:
        return cfg.with_updates(
            moe=dataclasses.replace(cfg.moe, capacity_factor=8.0))
    return cfg


def _close(port, want, tol):
    port, want = np.asarray(port, np.float64), np.asarray(want, np.float64)
    assert port.shape == want.shape
    err = np.abs(port - want).max()
    assert err <= tol * np.abs(want).max(), (err, np.abs(want).max())


def _configs(arch, window=None):
    jc, tc = j_get_config(arch, reduced=True), get_config(arch, reduced=True)
    if window:
        jc, tc = jc.windowed(window), tc.windowed(window)
    return jc, tc


def _inputs(cfg, shape, seed):
    rng = np.random.default_rng(seed)
    if cfg.input_mode == "tokens":
        return rng.integers(0, cfg.vocab_size, shape).astype(np.int32)
    return rng.normal(size=shape + (cfg.d_model,)).astype(np.float32)


def _torch_inputs(a):
    t = torch.from_numpy(a)
    return t.long() if t.dtype == torch.int32 else t


def _carried(arch, window=None):
    jc, tc = _configs(arch, window)
    jm, tm = JModel(jc), Model(tc)
    jp = jax.device_get(jm.init(jax.random.PRNGKey(0)))
    return jc, jm, jp, tm, params_from_jax(jp, device="cpu")


def _decode_vs_forward(tc, seed=0):
    model = Model(tc)
    params = model.init(torch.Generator().manual_seed(seed))
    inputs = _torch_inputs(_inputs(tc, (B, S), seed))
    full, _, _ = model.forward(params, inputs)
    caches = model.init_cache(B, S, device="cpu")
    outs = []
    for t in range(S):
        lg, caches = model.decode_step(params, inputs[:, t:t + 1], t, caches)
        outs.append(lg[:, 0])
    _close(torch.stack(outs, dim=1), full, DECODE_TOL)
    return caches


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward(arch):
    _decode_vs_forward(_uncapped(get_config(arch, reduced=True)))


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "nano-lm",
                                  "recurrentgemma-9b"])
def test_windowed_ring_buffer_decode(arch):
    """A windowed layer's cache is a ring of ``window`` rows, and decoding
    through it equals the windowed forward (RecurrentGemma: its local
    attention, the third block; the RG-LRU blocks keep no window)."""
    cfg = get_config(arch, reduced=True).windowed(8)
    caches = _decode_vs_forward(cfg)
    blk = next(f"b{i}" for i, b in enumerate(cfg.blocks[0][0])
               if b.mixer == "attn")
    assert caches[0][blk]["k"].shape[2] == 8
    # the ring holds the last 8 positions of each sequence
    assert sorted(caches[0][blk]["slot_pos"][0, 0].tolist()) \
        == list(range(S - 8, S))


STEP_CASES = [(a, None, 12) for a in ARCHS] + [
    ("qwen3-0.6b", 4, 12),     # a ring that wraps at staggered positions
    ("nano-lm", None, 5),      # a dense cache clamped past capacity
    ("deepseek-v3-671b", 4, 12),   # an MLA latent ring
]


@pytest.mark.parametrize("arch,window,length", STEP_CASES)
def test_decode_step_matches_jax_mid_stream(arch, window, length):
    """JAX decodes 6 steps with the two slots at staggered positions; its
    cache is carried to the port and both take 3 more steps: logits and
    k / v within STEP_TOL, ``slot_pos`` exactly, at every step."""
    jc, jm, jp, tm, tp = _carried(arch, window)
    inputs = _inputs(jc, (B, 9), seed=7)
    pos = lambda t: np.array([t, max(t - 3, 0)], np.int32)  # noqa: E731
    jcache = jm.init_cache(B, length)
    dec = jax.jit(jm.decode_step)
    for t in range(6):
        _, jcache = dec(jp, jnp.asarray(inputs[:, t:t + 1]),
                        jnp.asarray(pos(t)), jcache)
    tcache = caches_from_jax(jax.device_get(jcache), device="cpu")
    for t in range(6, 9):
        jl, jcache = dec(jp, jnp.asarray(inputs[:, t:t + 1]),
                         jnp.asarray(pos(t)), jcache)
        tl, tcache = tm.decode_step(tp, _torch_inputs(inputs[:, t:t + 1]),
                                    torch.from_numpy(pos(t)), tcache)
        _close(tl, jl, STEP_TOL)
        jleaves = jax.tree.leaves(jax.device_get(jcache))
        tleaves = jax.tree.leaves(caches_to_numpy(tcache))
        assert len(jleaves) == len(tleaves)
        for a, b in zip(jleaves, tleaves):
            assert a.shape == b.shape and a.dtype == b.dtype
            if a.dtype == np.int32:
                np.testing.assert_array_equal(b, a)
            else:
                _close(b, a, STEP_TOL)


@pytest.mark.parametrize("arch,window", [("qwen3-0.6b", None),
                                         ("qwen3-0.6b", 4),
                                         ("musicgen-medium", None)])
def test_prefill_matches_jax(arch, window):
    jc, jm, jp, tm, tp = _carried(arch, window)
    prompts = _inputs(jc, (B, 7), seed=3)
    jl, jcache = jm.prefill(jp, jnp.asarray(prompts), jm.init_cache(B, 10))
    tl, tcache = tm.prefill(tp, _torch_inputs(prompts),
                            tm.init_cache(B, 10, device="cpu"))
    _close(tl, jl, STEP_TOL)
    for a, b in zip(jax.tree.leaves(jax.device_get(jcache)),
                    jax.tree.leaves(caches_to_numpy(tcache))):
        if a.dtype == np.int32:
            np.testing.assert_array_equal(b, a)
        else:
            _close(b, a, STEP_TOL)


def test_prefill_is_the_token_loop_bitwise():
    """``prefill`` returns exactly what step P - 1 of the token-by-token
    loop returns, from a nonzero ``pos0`` too."""
    cfg = get_config("qwen3-0.6b", reduced=True)
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    prompts = _torch_inputs(_inputs(cfg, (B, 6), seed=1))
    caches = model.init_cache(B, 12, device="cpu")
    _, caches = model.decode_step(params, prompts[:, :1], 0, caches)
    got, gcache = model.prefill(params, prompts, caches, pos0=1)
    want, wcache = None, caches
    for t in range(6):
        want, wcache = model.decode_step(params, prompts[:, t:t + 1], 1 + t,
                                         wcache)
    assert torch.equal(got, want)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(gcache),
                                                 tree_leaves(wcache)))


@pytest.mark.parametrize("arch,dtype", [("qwen3-0.6b", "float32"),
                                        ("qwen3-0.6b", "bfloat16"),
                                        ("musicgen-medium", "float32"),
                                        ("deepseek-v3-671b", "float32"),
                                        ("mamba2-780m", "bfloat16"),
                                        ("recurrentgemma-9b", "float32")])
def test_init_cache_matches_jax(arch, dtype):
    jc, tc = _configs(arch)
    jc, tc = (jc.with_updates(compute_dtype=dtype),
              tc.with_updates(compute_dtype=dtype))
    for window in (None, 8):
        if window:
            jc, tc = jc.windowed(window), tc.windowed(window)
        want = jax.device_get(JModel(jc).init_cache(3, 20))
        got = caches_to_numpy(Model(tc).init_cache(3, 20, device="cpu"))
        assert jax.tree.structure(want) == jax.tree.structure(got)
        for a, b in zip(jax.tree.leaves(want), jax.tree.leaves(got)):
            assert a.shape == b.shape and a.dtype == b.dtype
            np.testing.assert_array_equal(
                b.view(np.uint16) if b.dtype == ml_dtypes.bfloat16 else b,
                a.view(np.uint16) if a.dtype == ml_dtypes.bfloat16 else a)


@pytest.mark.parametrize("arch", ["deepseek-v3-671b", "arctic-480b",
                                  "mamba2-780m", "recurrentgemma-9b"])
def test_decode_step_runs_under_vmap(arch):
    """The fleet vmaps the decode step over replicas: for every new mixer
    and mlp, a ``torch.func.vmap`` of ``decode_step`` over 2 replicas'
    parameters and caches equals each replica's own step (logits and
    caches within 1e-5 of their largest magnitude, ``slot_pos``
    exactly)."""
    cfg = get_config(arch, reduced=True)
    model = Model(cfg)
    reps = [model.init(torch.Generator().manual_seed(s)) for s in (0, 1)]
    stacked = tree_map(lambda *xs: torch.stack(xs), *reps)
    inputs = _torch_inputs(_inputs(cfg, (B, 4), seed=2))
    caches = [model.init_cache(B, 8, device="cpu") for _ in reps]
    for t in range(3):
        want = [model.decode_step(p, inputs[:, t:t + 1], t, c)
                for p, c in zip(reps, caches)]
        got, vcache = torch.func.vmap(
            lambda p, c: model.decode_step(p, inputs[:, t:t + 1], t, c))(
                stacked, tree_map(lambda *xs: torch.stack(xs), *caches))
        for r, (lg, c) in enumerate(want):
            _close(got[r], lg, STEP_TOL)
            for a, b in zip(tree_leaves(vcache), tree_leaves(c)):
                if b.dtype == torch.int32:
                    assert torch.equal(a[r], b)
                else:
                    _close(a[r], b, STEP_TOL)
        caches = [c for _, c in want]


def test_mla_cache_is_compressed():
    """MLA's cache holds the latents and the shared RoPE key, not per-head
    K and V (the JAX package's ``test_mla_cache_is_compressed``)."""
    cfg = get_config("deepseek-v3-671b", reduced=True)
    caches = Model(cfg).init_cache(B, S, device="cpu")
    for group in caches:
        cache = group["b0"]
        assert set(cache) == {"c", "k_rope", "slot_pos"}
        assert cache["c"].shape[-1] == cfg.mla.kv_lora_rank
        assert cache["k_rope"].shape[-1] == cfg.mla.qk_rope_head_dim


def test_ssm_cache_is_constant_size():
    """Mamba-2's cache has one size at every context length (the JAX
    package's ``test_ssm_cache_is_constant_size``)."""
    model = Model(get_config("mamba2-780m", reduced=True))
    small = model.init_cache(B, 32, device="cpu")
    large = model.init_cache(B, 4096, device="cpu")
    for a, b in zip(tree_leaves(small), tree_leaves(large)):
        assert a.shape == b.shape


@pytest.mark.parametrize("pos", [5, np.int32(5), np.array([4, 0, 9],
                                                          np.int32)])
@pytest.mark.parametrize("window", [None, 4])
def test_cache_helpers_match_jax(pos, window):
    """decode_positions, the dense clamp / ring slot and the visibility
    mask, exactly JAX's, for an int, a 0-d and a (B,) position."""
    tpos = torch.from_numpy(np.asarray(pos)) if isinstance(
        pos, (np.ndarray, np.generic)) else pos
    jvec = np.asarray(jatt.decode_positions(jnp.asarray(pos), 3))
    tvec = tatt.decode_positions(tpos, 3)
    assert tvec.dtype == torch.int32
    np.testing.assert_array_equal(tvec.numpy(), jvec)
    for size in (6, 3):
        jslot = np.asarray(jatt._cache_slots(jnp.asarray(jvec), size,
                                             window))
        np.testing.assert_array_equal(
            tatt._cache_slots(tvec, size, window).numpy(), jslot)
    spos = np.array([[0, 1, 2, 3, -1, -1], [4, 5, 6, 7, 8, 9],
                     [9, 8, 7, -1, 2, 1]], np.int32)
    np.testing.assert_array_equal(
        tatt._slot_mask(torch.from_numpy(spos), tvec, window).numpy(),
        np.asarray(jatt._slot_mask(jnp.asarray(spos), jnp.asarray(jvec),
                                   window)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32"])
def test_update_slot_matches_jax_bitwise(dtype):
    rng = np.random.default_rng(0)
    np_dtype = ml_dtypes.bfloat16 if dtype == "bfloat16" else dtype
    cache = rng.normal(size=(3, 5, 2, 4)).astype(np_dtype)
    update = rng.normal(size=(3, 1, 2, 4)).astype(np_dtype)
    slot = np.array([4, 0, 2], np.int32)
    want = np.asarray(jatt._update_slot(jnp.asarray(cache),
                                        jnp.asarray(update),
                                        jnp.asarray(slot)))
    tc, tu = caches_from_jax([cache, update], device="cpu")
    before = tc.clone()
    got = caches_to_numpy(tatt._update_slot(tc, tu, torch.from_numpy(slot)))
    view = np.uint16 if dtype == "bfloat16" else np_dtype
    np.testing.assert_array_equal(got.view(view), want.view(view))
    assert torch.equal(tc, before)   # out of place: the old cache intact


def test_caches_cross_both_ways_bitwise():
    jc = j_get_config("qwen3-0.6b", reduced=True).with_updates(
        param_dtype="bfloat16", compute_dtype="bfloat16")
    jm = JModel(jc)
    jp = jm.init(jax.random.PRNGKey(0))
    _, jcache = jm.decode_step(jp, jnp.ones((2, 1), jnp.int32),
                               jnp.asarray([3, 1], jnp.int32),
                               jm.init_cache(2, 6))
    want = jax.device_get(jcache)
    back = caches_to_numpy(caches_from_jax(want, device="cpu"))
    for a, b in zip(jax.tree.leaves(want), jax.tree.leaves(back)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(b.view(np.uint8), a.view(np.uint8))


def test_init_cache_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = Model(get_config("nano-lm", reduced=True))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.init_cache(1, 4)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["qwen3-0.6b", "musicgen-medium"])
def test_decode_matches_forward_on_card(arch):
    """The decode loop on the card against the same model's forward there
    (and against the CPU decode of the same weights)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m gpu on the card)")
    cfg = get_config(arch, reduced=True)
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    dev = torch.device("cuda")
    gparams = tree_map(lambda a: a.to(dev), params)
    inputs = _torch_inputs(_inputs(cfg, (B, S), 0))
    full, _, _ = model.forward(gparams, inputs.to(dev))
    caches = model.init_cache(B, S)
    outs = []
    for t in range(S):
        lg, caches = model.decode_step(gparams, inputs[:, t:t + 1].to(dev),
                                       t, caches)
        outs.append(lg[:, 0])
    _close(torch.stack(outs, dim=1).cpu(), full.cpu(), DECODE_TOL)
    cpu_full, _, _ = model.forward(params, inputs)
    _close(full.cpu(), cpu_full, DECODE_TOL)
