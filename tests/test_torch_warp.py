"""Two-pass warp: the port's plain ``resample_rows`` (the plain version of
K2) against the JAX package's Pallas ``resample_rows`` in interpret mode,
and the port's u16-encoded ``warp_two_pass[_b]`` against the JAX versions
(whose interpret path is f32)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vkvolume_tpu.render import plan as plan_mod
from vkvolume_tpu.render import warp_pallas as jwp
from vkvolume_tpu_torch.render import warp_cuda


def _positions(seed, Ho, Wo, Ws):
    """Smooth row-aligned positions (per-tile span well inside a 256 rect)
    with masked pixels and both source edges touched."""
    rng = np.random.default_rng(seed)
    x = np.arange(Wo, dtype=np.float64)[None, :]
    y = np.arange(Ho, dtype=np.float64)[:, None]
    pos = 3.0 + 0.55 * x + 0.9 * y + rng.uniform(-0.4, 0.4, (Ho, Wo))
    pos[:, :3] = -2.0                         # clamps to the left edge
    pos = np.minimum(pos, Ws - 1 + 0.3)       # clamps to the right edge
    pos[rng.random((Ho, Wo)) < 0.05] = -10.0  # masked pixels
    return pos.astype(np.float32)


@pytest.mark.parametrize("src_u16,encode_out", [(True, True), (True, False),
                                                (False, False), (False, True)])
def test_resample_rows_matches_pallas_interpret(src_u16, encode_out):
    rng = np.random.default_rng(7)
    C, Ho, Wo, Ws = 3, 16, 256, 300          # Ws not a multiple of 128
    pos = _positions(8, Ho, Wo, Ws)
    if src_u16:
        src = rng.integers(0, 65536, (C, Ho, Ws)).astype(np.uint16)
        full_scale = 65535.0
    else:
        src = rng.random((C, Ho, Ws)).astype(np.float32)
        full_scale = 1.0
        if encode_out:
            src *= np.float32(65535.0)
    want = np.asarray(jwp.resample_rows(jnp.asarray(src), jnp.asarray(pos),
                                        RECT=256, encode_out=encode_out,
                                        interpret=True))
    got = warp_cuda.resample_rows(torch.tensor(src), torch.tensor(pos),
                                  encode_out=encode_out).numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    if encode_out:
        assert np.abs(got.astype(np.int64) - want.astype(np.int64)).max() <= 1
    else:
        # 1e-6 of full scale: the TPU kernel may fuse the lerp's multiply-add.
        assert np.abs(got - want).max() <= 1e-6 * full_scale


def test_resample_rows_reference_semantics():
    """Masked pixels are 0, the clamp is to [0, Ws-1], u16 rounds half to
    even."""
    src = torch.tensor([[[10.0, 20.0, 30.0]]])
    pos = torch.tensor([[-10.0, -2.0, 0.25, 1.5, 5.0]])
    out = warp_cuda.resample_rows_reference(src, pos)
    np.testing.assert_allclose(out.numpy()[0, 0], [0.0, 10.0, 12.5, 25.0,
                                                   30.0])
    half = warp_cuda.resample_rows_reference(
        torch.tensor([[[0.0, 1.0, 4.0]]]), torch.tensor([[0.5, 1.5]]),
        encode_out=True)
    np.testing.assert_array_equal(half.numpy()[0, 0], [0, 2])


def _homography_case():
    """Mildly projective pixel→(wu, wv) map, a grid covering it and smooth
    [0, 1] content (tests/test_warp.py's set-up)."""
    H, W = 32, 128
    hc = np.array([0.010, 0.004, -0.20, 0.006, -0.009, 0.30,
                   2e-4, 1e-4, 1.0], np.float64)
    au, bu, cu, av, bv, cv, ap, bp, cp = hc
    i, j = np.meshgrid(np.arange(H, dtype=np.float64),
                       np.arange(W, dtype=np.float64), indexing="ij")
    den = ap * i + bp * j + cp
    wu = (au * i + bu * j + cu) / den
    wv = (av * i + bv * j + cv) / den
    Hi, Wi = 64, 256
    wu0 = wu.min() - 0.02
    wv0 = wv.min() - 0.02
    dwu = (wu.max() - wu.min() + 0.04) / Wi
    dwv = (wv.max() - wv.min() + 0.04) / Hi
    gx = ((wu - wu0) / dwu - 0.5).astype(np.float32)
    gy = ((wv - wv0) / dwv - 0.5).astype(np.float32)
    plan = dict(wu0=wu0, dwu=dwu, wv0=wv0, dwv=dwv, Hi=Hi, Wi=Wi)
    yy, xx = np.meshgrid(np.linspace(0, 3, Hi), np.linspace(0, 3, Wi),
                         indexing="ij")
    chans = np.stack([0.5 + 0.5 * np.sin(yy + 2 * xx),
                      0.5 + 0.5 * np.cos(2 * yy - xx),
                      (yy * 0.2 + xx * 0.1) / 1.0]).astype(np.float32)
    return hc, plan, chans, gx, gy, H, W


def test_warp_two_pass_b_matches_jax():
    hc, plan, chans, gx, gy, H, W = _homography_case()
    Hi, Wi = plan["Hi"], plan["Wi"]
    Hp = -(-H // 128) * 128
    xg, ii = np.meshgrid(np.arange(Wi, dtype=np.float64),
                         np.arange(Hp, dtype=np.float64), indexing="ij")
    yb, jhat = plan_mod.pass_b1_positions_np(hc, plan, xg, ii)
    ok = np.isfinite(yb) & (jhat >= -16.0) & (jhat <= W + 15.0) & (ii < H)
    yb = np.where(ok, yb, -10.0).astype(np.float32)
    gx_p = np.full((Hp, W), -10.0, np.float32)
    gx_p[:H] = gx
    want = np.asarray(jwp.warp_two_pass_b(
        jnp.asarray(chans), jnp.asarray(yb), jnp.asarray(gx_p), RECT_A=256,
        RECT_B=256, scales=[65535.0] * 3, interpret=True))
    got = warp_cuda.warp_two_pass_b(torch.tensor(chans), torch.tensor(yb),
                                    torch.tensor(gx_p),
                                    scales=[65535.0] * 3).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() < 2e-4


def test_warp_two_pass_a_matches_jax():
    hc, plan, chans, gx, gy, H, W = _homography_case()
    Hi = plan["Hi"]
    yg, j = np.meshgrid(np.arange(Hi, dtype=np.float64),
                        np.arange(W, dtype=np.float64), indexing="ij")
    xa, ihat = plan_mod.pass_a_positions_np(hc, plan, yg, j)
    ok = np.isfinite(xa) & (ihat >= -16.0) & (ihat <= H + 15.0)
    xa = np.where(ok, xa, -10.0).astype(np.float32)
    Hp = -(-H // 128) * 128
    gy_t = np.full((W, Hp), -10.0, np.float32)
    gy_t[:, :H] = gy.T
    want = np.asarray(jwp.warp_two_pass(
        jnp.asarray(chans), jnp.asarray(xa), jnp.asarray(gy_t), RECT_A=256,
        RECT_B=256, scales=[65535.0] * 3, interpret=True))
    got = warp_cuda.warp_two_pass(torch.tensor(chans), torch.tensor(xa),
                                  torch.tensor(gy_t),
                                  scales=[65535.0] * 3).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() < 2e-4


def test_wrapper_runs_plain_version_for_cpu_tensors():
    src = torch.rand(2, 8, 40)
    pos = torch.rand(8, 128) * 39.0
    before = dict(warp_cuda.LAUNCHES)
    got = warp_cuda.resample_rows(src, pos)
    assert warp_cuda.LAUNCHES == before
    np.testing.assert_array_equal(
        got.numpy(), warp_cuda.resample_rows_reference(src, pos).numpy())


def _today_two_pass(chans, xa, gy_t, scales):
    """The two-pass warp as separate steps (encode, resample, transpose,
    resample, transpose and decode): the composition K2's fused passes
    replace."""
    sc = torch.tensor(scales, dtype=torch.float32)[:, None, None]
    enc = torch.round(torch.clamp(chans * sc, 0.0, 65535.0)).to(torch.uint16)
    t = warp_cuda.resample_rows_reference(enc, xa, encode_out=True)
    out_t = warp_cuda.resample_rows_reference(t.transpose(1, 2).contiguous(),
                                              gy_t)
    return out_t.transpose(1, 2) / sc


def _today_two_pass_b(chans, yb, gx_p, scales):
    sc = torch.tensor(scales, dtype=torch.float32)[:, None, None]
    enc = torch.round(torch.clamp(chans.transpose(1, 2) * sc, 0.0,
                                  65535.0)).to(torch.uint16).contiguous()
    t = warp_cuda.resample_rows_reference(enc, yb, encode_out=True)
    return warp_cuda.resample_rows_reference(
        t.transpose(1, 2).contiguous(), gx_p) / sc


def _variant_inputs(variant):
    """(chans, pass-1 positions, pass-2 positions, H) of the homography
    case for warp variant A or B, as the frame builds them."""
    hc, plan, chans, gx, gy, H, W = _homography_case()
    Hi, Wi = plan["Hi"], plan["Wi"]
    Hp = -(-H // 128) * 128
    if variant == "B":
        xg, ii = np.meshgrid(np.arange(Wi, dtype=np.float64),
                             np.arange(Hp, dtype=np.float64), indexing="ij")
        yb, jhat = plan_mod.pass_b1_positions_np(hc, plan, xg, ii)
        ok = (np.isfinite(yb) & (jhat >= -16.0) & (jhat <= W + 15.0)
              & (ii < H))
        pos1 = np.where(ok, yb, -10.0).astype(np.float32)
        pos2 = np.full((Hp, W), -10.0, np.float32)
        pos2[:H] = gx
    else:
        yg, j = np.meshgrid(np.arange(Hi, dtype=np.float64),
                            np.arange(W, dtype=np.float64), indexing="ij")
        xa, ihat = plan_mod.pass_a_positions_np(hc, plan, yg, j)
        ok = np.isfinite(xa) & (ihat >= -16.0) & (ihat <= H + 15.0)
        pos1 = np.where(ok, xa, -10.0).astype(np.float32)
        pos2 = np.full((W, Hp), -10.0, np.float32)
        pos2[:, :H] = gy.T
    return chans, pos1, pos2, H


@pytest.mark.parametrize("C", [3, 4])
@pytest.mark.parametrize("variant", ["A", "B"])
def test_fused_passes_compose_to_todays_warp_and_jax(variant, C):
    """The plain fused passes (encode on load, transposed output, decode)
    give the separate-step warp bit for bit, and the JAX warp within the
    u16 quantisation; C = 4 adds a count channel warped at scale 1."""
    chans, pos1, pos2, H = _variant_inputs(variant)
    scales = [65535.0] * 3
    if C == 4:
        count = np.random.default_rng(9).integers(0, 400, chans.shape[1:])
        chans = np.concatenate([chans, count[None].astype(np.float32)])
        scales = scales + [1.0]
    args = [torch.tensor(a) for a in (chans, pos1, pos2)]
    if variant == "B":
        today = _today_two_pass_b(*args, scales)
        plain = warp_cuda.warp_two_pass_b_plain(*args, scales=scales)
        got = warp_cuda.warp_two_pass_b(*args, scales=scales)
        want = jwp.warp_two_pass_b(*[jnp.asarray(a) for a in
                                     (chans, pos1, pos2)],
                                   RECT_A=256, RECT_B=256, scales=scales,
                                   interpret=True)
    else:
        today = _today_two_pass(*args, scales)
        plain = warp_cuda.warp_two_pass_plain(*args, scales=scales)
        got = warp_cuda.warp_two_pass(*args, scales=scales)
        want = jwp.warp_two_pass(*[jnp.asarray(a) for a in
                                   (chans, pos1, pos2)],
                                 RECT_A=256, RECT_B=256, scales=scales,
                                 interpret=True)
    assert plain.is_contiguous() and plain.shape == today.shape
    np.testing.assert_array_equal(plain.numpy(), today.numpy())
    np.testing.assert_array_equal(got.numpy(), plain.numpy())
    want = np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got[:3].numpy() - want[:3]).max() < 2e-4
    if C == 4:
        # The count channel at scale 1: within one count per pass.
        assert np.abs(got[3].numpy() - want[3]).max() <= 2.0
        assert float(got[3, :H].max()) > 0.0


@pytest.mark.parametrize("column_src,transpose_out", [(False, True),
                                                      (True, True),
                                                      (True, False)])
def test_resample_pass_options_match_separate_steps(column_src,
                                                    transpose_out):
    """One plain pass with its options against the separate steps; the
    wrapper's checks of the options."""
    rng = np.random.default_rng(11)
    C, lines, n_src, n_pos = 3, 12, 37, 40
    src = rng.random((C, n_src, lines) if column_src else (C, lines, n_src))
    src = torch.tensor(src.astype(np.float32))
    pos = torch.tensor(_positions(12, lines, n_pos, n_src))
    scales = [65535.0, 300.0, 1.0]
    got = warp_cuda.resample_pass(src, pos, encode_out=True, scales_in=scales,
                                  column_src=column_src,
                                  transpose_out=transpose_out)
    s = src.transpose(1, 2) if column_src else src
    sc = torch.tensor(scales)[:, None, None]
    enc = torch.round(torch.clamp(s * sc, 0.0, 65535.0)).to(torch.uint16)
    want = warp_cuda.resample_rows_reference(enc, pos, encode_out=True)
    want = want.transpose(1, 2) if transpose_out else want
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    dec = warp_cuda.resample_pass(enc, pos, scales_out=scales,
                                  transpose_out=transpose_out)
    want = warp_cuda.resample_rows_reference(enc, pos) / sc
    want = want.transpose(1, 2) if transpose_out else want
    np.testing.assert_array_equal(dec.numpy(), want.numpy())
    for kw in (dict(scales_in=scales[:2]), dict(scales_out=scales,
                                                 encode_out=True)):
        with pytest.raises(ValueError):
            warp_cuda.resample_pass(src, pos, column_src=column_src, **kw)
    with pytest.raises(ValueError):
        warp_cuda.resample_pass(enc, pos, scales_in=scales)
