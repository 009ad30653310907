"""Port parity for multi-head latent attention (``models/attention.py``) and
multi-token prediction (``models/transformer.py``), on the reduced
DeepSeek-V3 with the JAX package's weights carried by ``convert``:
``apply_mla`` (causal and windowed), ``decode_mla`` from a JAX cache carried
mid-stream with the sequences at staggered positions, the compressed cache's
layout, and the MTP loss.

Tolerances, relative to the largest magnitude of the tensor compared: the
mixer's output, the cached latents and the MTP loss 1e-5 (the same f32
matmuls and einsums summed in another order by XLA and PyTorch);
``slot_pos`` exactly.
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
from repro_torch.models import attention as tatt
from repro_torch.models.transformer import Model

B, S, TOL = 2, 24, 1e-5
ARCH = "deepseek-v3-671b"


def _close(port, want, tol=TOL):
    port = np.asarray(port, np.float64)
    want = np.asarray(want, np.float64)
    assert port.shape == want.shape
    err = np.abs(port - want).max()
    assert err <= tol * np.abs(want).max(), (err, np.abs(want).max())


@pytest.fixture(scope="module")
def mla():
    jc, tc = j_get_config(ARCH, reduced=True), get_config(ARCH, reduced=True)
    jp = jax.device_get(jatt.init_mla(jax.random.PRNGKey(3), jc,
                                      jnp.float32))
    return jc, tc, jp, params_from_jax(jp, device="cpu")


@pytest.mark.parametrize("window", [None, 7])
def test_apply_mla_matches_jax(mla, window):
    jc, tc, jp, tp = mla
    rng = np.random.default_rng(0)
    x = rng.normal(size=(B, S, jc.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    want = jatt.apply_mla(jp, jc, jnp.asarray(x), jnp.asarray(pos), window)
    got = tatt.apply_mla(tp, tc, torch.from_numpy(x), torch.from_numpy(pos),
                         window)
    _close(got, want)


@pytest.mark.parametrize("window,length", [(None, 12), (4, 12)])
def test_decode_mla_matches_jax_mid_stream(mla, window, length):
    """JAX decodes 6 steps with the sequences at positions (t, t - 3); the
    cache is carried and both take 3 more steps: the output and the
    latents within 1e-5, ``slot_pos`` exactly, at every step."""
    jc, tc, jp, tp = mla
    rng = np.random.default_rng(1)
    xs = rng.normal(size=(9, B, 1, jc.d_model)).astype(np.float32)
    pos = lambda t: np.array([t, max(t - 3, 0)], np.int32)  # noqa: E731
    jcache = jatt.init_mla_cache(jc, B, length, window, jnp.float32)
    dec = jax.jit(lambda x, p, c: jatt.decode_mla(jp, jc, x, p, c, window))
    for t in range(6):
        _, jcache = dec(jnp.asarray(xs[t]), jnp.asarray(pos(t)), jcache)
    tcache = params_from_jax(jax.device_get(jcache), device="cpu")
    for t in range(6, 9):
        jout, jcache = dec(jnp.asarray(xs[t]), jnp.asarray(pos(t)), jcache)
        tout, tcache = tatt.decode_mla(tp, tc, torch.from_numpy(xs[t]),
                                       torch.from_numpy(pos(t)), tcache,
                                       window)
        _close(tout, jout)
        for key in ("c", "k_rope"):
            _close(tcache[key], jcache[key])
        np.testing.assert_array_equal(tcache["slot_pos"].numpy(),
                                      np.asarray(jcache["slot_pos"]))


def test_mla_cache_layout_matches_jax(mla):
    jc, tc, _, _ = mla
    for window in (None, 8):
        want = jax.device_get(jatt.init_mla_cache(jc, 3, 20, window,
                                                  jnp.float32))
        got = tatt.init_mla_cache(tc, 3, 20, window, torch.float32)
        assert set(got) == set(want) == {"c", "k_rope", "slot_pos"}
        for key in want:
            assert tuple(got[key].shape) == want[key].shape
            np.testing.assert_array_equal(got[key].numpy(), want[key])


def test_mtp_loss_matches_jax():
    jc, tc = j_get_config(ARCH, reduced=True), get_config(ARCH, reduced=True)
    jm, tm = JModel(jc), Model(tc)
    jp = jax.device_get(jm.init(jax.random.PRNGKey(0)))
    tp = params_from_jax(jp, device="cpu")
    assert set(tp["mtp"]) == {"proj", "norm", "block"}
    rng = np.random.default_rng(4)
    toks = rng.integers(0, jc.vocab_size, (B, S + 1)).astype(np.int32)
    jb = {"inputs": jnp.asarray(toks[:, :-1]),
          "labels": jnp.asarray(toks[:, 1:])}
    tb = {"inputs": torch.from_numpy(toks[:, :-1]).long(),
          "labels": torch.from_numpy(toks[:, 1:]).long()}
    _, _, jh = jm.forward(jp, jb["inputs"])
    want = jm._mtp_loss(jp, jb, jh)
    _, _, th = tm.forward(tp, tb["inputs"])
    _close(tm._mtp_loss(tp, tb, th).item(), float(want))
    # the loss adds 0.3 mtp and the aux; embedding inputs take no mtp
    jloss, jmet = jm.loss(jp, jb)
    tloss, tmet = tm.loss(tp, tb)
    assert set(tmet) == set(jmet) == {"ce", "aux", "mtp"}
    for key in jmet:
        _close(tmet[key].item(), float(jmet[key]))
    _close(tloss.item(), float(jloss))
    emb = Model(tc.with_updates(input_mode="embeddings"))
    eparams = emb.init(torch.Generator().manual_seed(0))
    _, met = emb.loss(eparams, {"inputs": torch.zeros(B, 4, tc.d_model),
                                "labels": tb["labels"][:, :4]})
    assert set(met) == {"ce", "aux"}
