"""Port parity for the transformer family on the xla attention path, f32:
the JAX package's weights carried with ``convert``; the port's logits, MoE
aux, loss (ce, aux, mtp) and per-leaf gradients equal
``jax.value_and_grad(model.loss)`` on the dense archs and on reduced
DeepSeek-V3, Arctic, Mamba-2 and RecurrentGemma; the pieces (RoPE at a
fraction, the ``_sdpa`` decode branch) equal their JAX twins.

Tolerances, each relative to the largest magnitude of the tensor compared
(max|port - JAX| <= tol * max|JAX|): logits, final hidden state and loss
1e-5, gradients 1e-4 — the same f32 einsums, matmuls and reductions,
summed in another order by XLA and PyTorch; the MoE aux 1e-6 relative.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import Model as JModel
from repro.models import attention as jatt
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.core.tree import tree_leaves
from repro_torch.models import attention as tatt
from repro_torch.models.transformer import Model

B, S = 2, 48
CASES = [  # (arch, window): nano-lm, qwen3 (qk-norm, rope 1e6), windowed,
    ("nano-lm", None),  # partial RoPE, and embeddings in + gelu + codebooks
    ("qwen3-0.6b", None),
    ("qwen3-0.6b", 32),
    ("glm4-9b", None),
    ("musicgen-medium", None),
    ("deepseek-v3-671b", None),  # MLA, MoE with a shared expert, MTP
    ("arctic-480b", None),       # GQA with a MoE beside a dense mlp
    ("mamba2-780m", None),       # Mamba-2 SSD
    ("recurrentgemma-9b", None),  # RG-LRU beside local attention
]


def _close(port, want, tol):
    want = np.asarray(want)
    assert port.shape == want.shape
    err = np.abs(port - want).max()
    assert err <= tol * np.abs(want).max(), (err, np.abs(want).max())


def _configs(arch, window):
    jc, tc = j_get_config(arch, reduced=True), get_config(arch, reduced=True)
    if window:
        jc, tc = jc.windowed(window), tc.windowed(window)
    return jc, tc


def _batch(cfg, seed):
    rng = np.random.default_rng(seed)
    s = S if cfg.ssm is None else 2 * cfg.ssm.chunk   # whole SSD chunks
    if cfg.input_mode == "tokens":
        inputs = rng.integers(0, cfg.vocab_size, (B, s)).astype(np.int32)
    else:
        inputs = rng.normal(size=(B, s, cfg.d_model)).astype(np.float32)
    shape = (B, s) if cfg.num_codebooks == 1 else (B, s, cfg.num_codebooks)
    labels = rng.integers(0, cfg.vocab_size, shape).astype(np.int32)
    return inputs, labels


@pytest.mark.parametrize("arch,window", CASES)
def test_logits_loss_grads_match_jax(arch, window):
    jc, tc = _configs(arch, window)
    jm, tm = JModel(jc), Model(tc)
    jp = jax.device_get(jm.init(jax.random.PRNGKey(0)))
    tp = params_from_jax(jp, device="cpu")
    inputs, labels = _batch(jc, seed=len(arch))
    jb = {"inputs": jnp.asarray(inputs), "labels": jnp.asarray(labels)}
    tb = {"inputs": torch.from_numpy(inputs),
          "labels": torch.from_numpy(labels).long()}
    if jc.input_mode == "tokens":
        tb["inputs"] = tb["inputs"].long()

    jl, jaux, jh = jm.forward(jp, jb["inputs"])
    tl, aux, th = tm.forward(tp, tb["inputs"])
    assert tl.shape == jl.shape
    if jc.moe is None:
        assert aux.item() == 0.0
    else:
        assert aux.item() > 0.0
        np.testing.assert_allclose(aux.item(), float(jaux), rtol=1e-6)
    _close(tl.numpy(), jl, 1e-5)
    _close(th.numpy(), jh, 1e-5)

    (jloss, jmet), jg = jax.value_and_grad(jm.loss, has_aux=True)(jp, jb)
    tg, tloss = torch.func.grad_and_value(
        lambda p: tm.loss(p, tb)[0])(tp)
    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=1e-5)
    tmet = tm.loss(tp, tb)[1]
    assert set(tmet) == set(jmet)
    for key in jmet:   # ce, aux and, with MTP, mtp
        np.testing.assert_allclose(tmet[key].item(), float(jmet[key]),
                                   rtol=1e-5)
    jleaves, tleaves = jax.tree.leaves(jg), tree_leaves(tg)
    assert len(jleaves) == len(tleaves)
    for a, b in zip(jleaves, tleaves):
        _close(b.numpy(), a, 1e-4)


@pytest.mark.parametrize("fraction,theta", [(1.0, 1e4), (0.5, 1e4),
                                            (1.0, 1e6)])
def test_rope_matches_jax(fraction, theta):
    rot, inv = tatt.rope_freqs(64, theta, fraction)
    jrot, jinv = jatt.rope_freqs(64, theta, fraction)
    assert rot == jrot
    np.testing.assert_array_equal(inv, np.asarray(jinv))
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 40, 3, 64)).astype(np.float32)
    pos = np.broadcast_to(np.arange(40, dtype=np.int32), (2, 40))
    out = tatt.apply_rope(torch.from_numpy(x), torch.from_numpy(pos.copy()),
                          theta, fraction)
    want = jatt.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta,
                           fraction)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    if fraction < 1.0:   # the unrotated half passes through untouched
        assert torch.equal(out[..., 32:], torch.from_numpy(x)[..., 32:])


@pytest.mark.parametrize("h,kv", [(4, 2), (4, 4), (6, 1)])
def test_sdpa_decode_branch_matches_jax(h, kv):
    """S == 1 against a (B, T) visibility mask: the grouped einsum when
    KV != H, the broadcast path otherwise."""
    rng = np.random.default_rng(h + kv)
    b, t, hd = 3, 20, 32
    q = rng.normal(size=(b, 1, h, hd)).astype(np.float32)
    k = rng.normal(size=(b, t, kv, hd)).astype(np.float32)
    v = rng.normal(size=(b, t, kv, hd)).astype(np.float32)
    mask = rng.random((b, 1, t)) < 0.7
    mask[:, :, 0] = True
    cfg = get_config("nano-lm", reduced=True)
    out = tatt._sdpa(*map(torch.from_numpy, (q, k, v, mask)), cfg)
    want = jatt._sdpa(*map(jnp.asarray, (q, k, v, mask)),
                      j_get_config("nano-lm", reduced=True))
    assert out.shape == (b, 1, h * hd)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def test_causal_mask_matches_jax():
    for window in (None, 5):
        np.testing.assert_array_equal(
            tatt.causal_mask(12, window).numpy(),
            np.asarray(jatt.causal_mask(12, window)))


@pytest.mark.parametrize("arch", ["deepseek-v3-671b", "mamba2-780m"])
def test_lm_grad_fn_vmaps_over_workers(arch):
    """``lm_grad_fn`` runs the MoE, MLA, MTP and SSD paths under
    ``torch.func.vmap`` over 2 workers' parameters; each worker's loss and
    gradients equal a separate ``grad_and_value`` call within 1e-6 of the
    largest gradient (vmap batches the matmuls, which sum in another
    order)."""
    from repro_torch.core.tree import tree_map
    from repro_torch.data import LMTaskStream
    from repro_torch.models.transformer import lm_grad_fn
    cfg = get_config(arch, reduced=True)
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    s = cfg.ssm.chunk if cfg.ssm else 16
    stream = LMTaskStream(vocab_size=cfg.vocab_size, seq_len=s,
                          batch_size=2, seed=0, device="cpu")
    xs = tree_map(lambda a: torch.stack([a, 1.01 * a]), params)
    losses, grads = lm_grad_fn(model, stream)(
        xs, torch.Generator().manual_seed(3), torch.arange(2))
    batch = stream.sample_workers(torch.Generator().manual_seed(3), 2)
    for w in range(2):
        g, loss = torch.func.grad_and_value(
            lambda p: model.loss(p, {"inputs": batch["inputs"][w],
                                     "labels": batch["labels"][w]})[0]
        )(tree_map(lambda a: a[w], xs))
        np.testing.assert_allclose(losses[w].item(), loss.item(), rtol=1e-6)
        top = max(a.abs().max().item() for a in tree_leaves(g))
        for a, b in zip(tree_leaves(grads), tree_leaves(g)):
            assert (a[w] - b).abs().max().item() <= 1e-6 * top
