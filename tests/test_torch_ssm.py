"""Port parity for the Mamba-2 SSD mixer (``models/ssm.py``) on the reduced
mamba2-780m with the JAX package's weights carried by ``convert``: the
numpy-drawn leaves of ``init_ssd`` bit for bit, the pieces (``_segsum``,
``_causal_conv``, ``ssd_chunked``), ``apply_ssd`` and ``decode_ssd`` from
a JAX state carried mid-stream, and the cache's layout.

Tolerances, relative to the largest magnitude of the tensor compared: 1e-5
(the chunked scan's contractions are taken pairwise here, in an order of
the port's own, where XLA picks the einsum path; the f32 sums differ in
order only); ``_segsum``'s mask and the numpy-drawn leaves exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import ssm as jssm
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.models import ssm as tssm

ARCH, B, TOL = "mamba2-780m", 2, 1e-5


def _close(port, want, tol=TOL):
    port = np.asarray(port, np.float64)
    want = np.asarray(want, np.float64)
    assert port.shape == want.shape
    err = np.abs(port - want).max()
    assert err <= tol * np.abs(want).max(), (err, np.abs(want).max())


@pytest.fixture(scope="module")
def ssd():
    jc, tc = j_get_config(ARCH, reduced=True), get_config(ARCH, reduced=True)
    jp = jax.device_get(jssm.init_ssd(jax.random.PRNGKey(0), jc,
                                      jnp.float32))
    # a live conv bias and norm scale, so that both are exercised
    rng = np.random.default_rng(9)
    jp["conv_b"] = rng.normal(size=jp["conv_b"].shape).astype(np.float32)
    jp["norm"] = 0.1 * rng.normal(size=jp["norm"].shape).astype(np.float32)
    return jc, tc, jp, params_from_jax(jp, device="cpu")


@pytest.mark.parametrize("arch", [ARCH])
@pytest.mark.parametrize("reduced", [True, False])
def test_init_ssd_numpy_leaves_bitwise(arch, reduced):
    jc, tc = j_get_config(arch, reduced), get_config(arch, reduced)
    want = jax.device_get(jssm.init_ssd(jax.random.PRNGKey(0), jc,
                                        jnp.float32))
    got = tssm.init_ssd(torch.Generator().manual_seed(0), tc, torch.float32)
    assert set(got) == set(want)
    for key in want:
        assert tuple(got[key].shape) == want[key].shape
        assert got[key].dtype == torch.float32
    for key in ("A_log", "dt_bias", "D", "norm", "conv_b"):
        np.testing.assert_array_equal(got[key].numpy(), want[key])


def test_segsum_and_conv_match_jax():
    rng = np.random.default_rng(0)
    a = -rng.random((2, 3, 8)).astype(np.float32)
    want = np.asarray(jssm._segsum(jnp.asarray(a)))
    got = tssm._segsum(torch.from_numpy(a)).numpy()
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    np.testing.assert_allclose(got[~np.isinf(got)], want[~np.isinf(want)],
                               rtol=1e-6, atol=1e-6)
    x = rng.normal(size=(2, 9, 5)).astype(np.float32)
    w = rng.normal(size=(4, 5)).astype(np.float32)
    b = rng.normal(size=(5,)).astype(np.float32)
    state = rng.normal(size=(2, 3, 5)).astype(np.float32)
    for st in (None, state):
        jout, jst = jssm._causal_conv(*map(jnp.asarray, (x, w, b)),
                                      None if st is None
                                      else jnp.asarray(st))
        tout, tst = tssm._causal_conv(
            *map(torch.from_numpy, (x, w, b)),
            None if st is None else torch.from_numpy(st))
        _close(tout, jout)
        np.testing.assert_array_equal(tst.numpy(), np.asarray(jst))


@pytest.mark.parametrize("s,chunk", [(32, 8), (24, 24)])
def test_ssd_chunked_matches_jax(s, chunk):
    rng = np.random.default_rng(s)
    h, p, n = 3, 4, 5
    x = rng.normal(size=(B, s, h, p)).astype(np.float32)
    a = -0.3 * rng.random((B, s, h)).astype(np.float32)
    b_ = rng.normal(size=(B, s, h, n)).astype(np.float32)
    c_ = rng.normal(size=(B, s, h, n)).astype(np.float32)
    jy, jh = jssm.ssd_chunked(*map(jnp.asarray, (x, a, b_, c_)), chunk)
    ty, th = tssm.ssd_chunked(*map(torch.from_numpy, (x, a, b_, c_)), chunk)
    _close(ty, jy)
    _close(th, jh)
    with pytest.raises(AssertionError, match="not divisible"):
        tssm.ssd_chunked(*map(torch.from_numpy, (x, a, b_, c_)), 7)


def test_apply_ssd_matches_jax(ssd):
    jc, tc, jp, tp = ssd
    x = np.random.default_rng(1).normal(
        size=(B, 2 * tc.ssm.chunk, jc.d_model)).astype(np.float32)
    _close(tssm.apply_ssd(tp, tc, torch.from_numpy(x)),
           jssm.apply_ssd(jp, jc, jnp.asarray(x)))


def test_decode_ssd_matches_jax_mid_stream(ssd):
    """JAX takes 5 decode steps; its state is carried and both take 3 more:
    the output and the state within 1e-5 at every step."""
    jc, tc, jp, tp = ssd
    xs = np.random.default_rng(2).normal(
        size=(8, B, 1, jc.d_model)).astype(np.float32)
    jcache = jssm.init_ssd_cache(jc, B, jnp.float32)
    dec = jax.jit(lambda x, c: jssm.decode_ssd(jp, jc, x, 0, c))
    for t in range(5):
        _, jcache = dec(jnp.asarray(xs[t]), jcache)
    tcache = params_from_jax(jax.device_get(jcache), device="cpu")
    for t in range(5, 8):
        jout, jcache = dec(jnp.asarray(xs[t]), jcache)
        tout, tcache = tssm.decode_ssd(tp, tc, torch.from_numpy(xs[t]), t,
                                       tcache)
        _close(tout, jout)
        for key in ("h", "conv"):
            _close(tcache[key], jcache[key])


def test_ssd_cache_layout_matches_jax():
    jc, tc = j_get_config(ARCH, reduced=True), get_config(ARCH, reduced=True)
    want = jax.device_get(jssm.init_ssd_cache(jc, 3, jnp.float32))
    got = tssm.init_ssd_cache(tc, 3, torch.float32)
    assert set(got) == set(want) == {"h", "conv"}
    for key in want:
        assert tuple(got[key].shape) == want[key].shape
        assert not got[key].any()
