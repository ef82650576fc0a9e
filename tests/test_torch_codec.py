"""The port's delta-wire codec path against the JAX package on the CPU:
K5 (tile_maxdiff) and K6 (dct8x8_quant) plain versions against the
reference's Pallas kernels (interpret mode) and goldens, the YCbCr 4:2:0
stage, the device probe and the fused transform, and the JPEG / delta /
coefficient wire bytes.

K6 note. The reference golden states its order of operations (level
shift, then each pass as ``acc = D[u,0]·x0``, ``acc + D[u,k]·xk``, no
fused multiply-add) and bars FMA contraction with an optimization barrier.
XLA's CPU compiler drops that barrier: the compiled golden fuses the
products and sums into one loop, and its results are not the stated
sequence's for some inputs. The port's plain version (and the CUDA kernel,
which matches it bit for bit on the card) follows the stated sequence; it
is held bit-exact to an independent numpy float32 evaluation of that
sequence. Against the JAX golden it is bit-exact on the reference's own
test planes (uniform float32), and elsewhere it differs only by one on
coefficients whose exact value lies on a rounding tie.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dvf_tpu.ops import pallas_kernels as pk
from dvf_tpu.runtime import codec_assist as jca
from dvf_tpu.transport import codec as jcodec
from dvf_tpu_torch.ops import kernels as tk
from dvf_tpu_torch.runtime import codec_assist as tca
from dvf_tpu_torch.transport import codec as tcodec

H, W, TILE = 48, 64, 16


def _pair(rng, shape):
    a = rng.integers(0, 256, shape, dtype=np.uint8)
    b = a.copy()
    b[..., 3:9, 5:30, :] = rng.integers(0, 256, b[..., 3:9, 5:30, :].shape,
                                        dtype=np.uint8)
    b[..., -1, -1, :] ^= 7
    return a, b


def _stream(rng, n, h=H, w=W):
    """Seeded frames: static noise base and a re-randomized region."""
    base = rng.integers(0, 255, (h, w, 3), np.uint8)
    out = [base.copy()]
    for _ in range(1, n):
        f = out[-1].copy()
        f[16:32, 16:48] = rng.integers(0, 255, (16, 32, 3), np.uint8)
        out.append(f)
    return out


# -- K5 ------------------------------------------------------------------


@pytest.mark.parametrize("shape,tile", [
    ((2, 64, 96, 3), 16), ((2, 64, 96, 1), 8), ((2, 32, 64, 4), 32),
    ((64, 96, 3), 16),
])
def test_tile_maxdiff_matches_pallas_aligned(shape, tile):
    a, b = _pair(np.random.default_rng(1), shape)
    want = np.asarray(pk.tile_maxdiff_pallas(jnp.asarray(a), jnp.asarray(b), tile,
                                             interpret=True))
    got = tk.tile_maxdiff(torch.from_numpy(a), torch.from_numpy(b), tile).numpy()
    assert got.dtype == np.uint8 and np.array_equal(got, want)


@pytest.mark.parametrize("shape,tile", [
    ((2, 68, 40, 3), 16), ((2, 68, 40, 1), 8), ((3, 45, 77, 4), 16),
    ((67, 41, 3), 32),
])
def test_tile_maxdiff_matches_golden_unaligned(shape, tile):
    a, b = _pair(np.random.default_rng(2), shape)
    want = np.asarray(pk.tile_maxdiff_ref(jnp.asarray(a), jnp.asarray(b), tile))
    got = tk.tile_maxdiff(torch.from_numpy(a), torch.from_numpy(b), tile).numpy()
    assert np.array_equal(got, want)
    if len(shape) == 3 and shape[-1] == 3:
        assert np.array_equal(got, jcodec.host_tile_maxdiff(a, b, tile))


# -- K6 ------------------------------------------------------------------


def test_jpeg_quant_tables_and_dct_matrix_match():
    for q in range(1, 101):
        for chroma in (False, True):
            assert np.array_equal(tk.jpeg_quant_table(q, chroma),
                                  pk.jpeg_quant_table(q, chroma))
    assert np.array_equal(tk._DCT8, pk._DCT8)
    assert np.array_equal(np.repeat(tk._qrecip(tk.jpeg_quant_table(90)), 3, axis=1),
                          pk._qrecip_lanes(pk.jpeg_quant_table(90), 3))


def _stated_sequence(plane: np.ndarray, qtable) -> np.ndarray:
    """The golden's stated operation order in numpy float32 (numpy never
    fuses a multiply and an add): (B, H, W) with H, W multiples of 8."""
    f32 = np.float32
    b, h, w = plane.shape
    x = plane.astype(f32).reshape(b, h // 8, 8, w // 8, 8).transpose(0, 1, 3, 2, 4)
    rows = [x[..., y, :] - f32(128) for y in range(8)]
    d = tk._DCT8
    vert = []
    for u in range(8):
        acc = d[u, 0] * rows[0]
        for y in range(1, 8):
            acc = acc + d[u, y] * rows[y]
        vert.append(acc)
    v = np.stack(vert, axis=-2)
    horiz = []
    for u in range(8):
        acc = d[u, 0] * v[..., 0]
        for k in range(1, 8):
            acc = acc + d[u, k] * v[..., k]
        horiz.append(acc)
    t = np.stack(horiz, axis=-1)
    return np.round(t * tk._qrecip(qtable)).astype(np.int16)


def _exact(plane: np.ndarray, qtable) -> np.ndarray:
    """T · (1/q) in float64 with exact DCT constants."""
    b, h, w = plane.shape
    x = plane.astype(np.float64).reshape(b, h // 8, 8, w // 8, 8).transpose(0, 1, 3, 2, 4)
    d = tk._DCT8.astype(np.float64)
    t = d @ (x - 128.0) @ d.T
    return t / np.asarray(qtable, np.float64)


SHAPES = [(2, 64, 128), (1, 8, 8), (3, 48, 64)]


@pytest.mark.parametrize("quality", [50, 90, 95, 100])
def test_dct8x8_quant_float_planes_bit_exact_to_reference(quality):
    """The reference's own test planes (uniform float32): bit-exact to its
    golden and to its Pallas kernel in interpret mode, and to the stated
    sequence; the unaligned (2, 52, 100) plane against the golden."""
    rng = np.random.default_rng(quality)
    q = tk.jpeg_quant_table(quality)
    for shape in SHAPES:
        plane = rng.uniform(0, 255, shape).astype(np.float32)
        got = tk.dct8x8_quant(torch.from_numpy(plane), q).numpy()
        assert got.dtype == np.int16
        assert np.array_equal(got, np.asarray(pk.dct8x8_quant_ref(jnp.asarray(plane), q)))
        assert np.array_equal(got, np.asarray(pk.dct8x8_quant_pallas(
            jnp.asarray(plane), q, interpret=True)))
        assert np.array_equal(got, _stated_sequence(plane, q))
    plane = rng.uniform(0, 255, (2, 52, 100)).astype(np.float32)
    got = tk.dct8x8_quant(torch.from_numpy(plane), q).numpy()
    assert got.shape == (2, 7, 13, 8, 8)
    assert np.array_equal(got, np.asarray(pk.dct8x8_quant(jnp.asarray(plane), q)))


# Differing coefficients the seeds below give against the JAX golden on
# uint8 planes (XLA CPU fuses the golden's products and sums).
_U8_DIFFS = {50: 1, 90: 15, 95: 34, 100: 93}


@pytest.mark.parametrize("quality", [50, 90, 95, 100])
def test_dct8x8_quant_uint8_planes(quality):
    """uint8 planes (the path's): bit-exact to the stated sequence, edge
    padding included; against the JAX golden and its interpret-mode kernel
    every differing coefficient is off by one and sits on a rounding tie
    of the exact transform (within 1e-4 of k + 0.5)."""
    rng = np.random.default_rng(100 + quality)
    q = tk.jpeg_quant_table(quality, chroma=quality == 50)
    n_diff = 0
    for shape in SHAPES + [(2, 56, 104)]:
        plane = rng.integers(0, 256, shape, dtype=np.uint8)
        got = tk.dct8x8_quant(torch.from_numpy(plane), q).numpy()
        assert np.array_equal(got, _stated_sequence(plane, q))
        want = np.asarray(pk.dct8x8_quant_ref(jnp.asarray(plane), q))
        assert np.array_equal(want, np.asarray(pk.dct8x8_quant_pallas(
            jnp.asarray(plane), q, interpret=True)))
        diff = got.astype(np.int32) - want
        assert np.abs(diff).max() <= 1
        frac = np.abs(np.abs(_exact(plane, q)) % 1.0 - 0.5)
        assert (frac[diff != 0] < 1e-4).all()
        n_diff += int((diff != 0).sum())
    assert n_diff == _U8_DIFFS[quality]
    # an unaligned uint8 plane: the edge pad is the golden's
    plane = rng.integers(0, 256, (2, 52, 100), dtype=np.uint8)
    padded = np.pad(plane, ((0, 0), (0, 4), (0, 4)), mode="edge")
    assert np.array_equal(tk.dct8x8_quant(torch.from_numpy(plane), q).numpy(),
                          _stated_sequence(padded, q))


# The CUDA kernel's uint8 instantiation replaces two conversions by float
# identities (csrc/codec.cu); float32 numpy evaluates them as the card does.


def test_level_shift_identity_every_byte():
    """2^23 + v, built as the bits 0x4B0000vv, minus 2^23 + 128 is
    float32(v) - 128 for every byte v."""
    v = np.arange(256, dtype=np.uint32)
    got = (0x4B000000 | v).view(np.float32) + np.float32(-8388736.0)
    assert got.dtype == np.float32
    assert np.array_equal(got, v.astype(np.float32) - np.float32(128))


def _magic_round_int16(q: np.ndarray) -> np.ndarray:
    bits = (q.astype(np.float32) + np.float32(12582912.0)).view(np.uint32)
    return (bits & 0xFFFF).astype(np.uint16).view(np.int16)


def test_round_identity_over_the_uint8_quotient_range():
    """q + 1.5 * 2^23 in float32 keeps round_half_even(q) in its low 16
    bits for every quotient the uint8 path gives (|q| <= 1024): every
    multiple of 2^-8 in [-1024, 1024] (all integers and all ±k.5 ties),
    the float32 neighbours of each, and 10^6 random float32 values."""
    grid = np.arange(-1024 * 256, 1024 * 256 + 1, dtype=np.int64).astype(np.float32) / 256
    assert grid.dtype == np.float32
    ties = grid[np.abs(grid % 1) == 0.5]
    assert len(ties) == 2048
    rng = np.random.default_rng(8)
    q = np.concatenate([grid, np.nextafter(grid, np.float32(np.inf)),
                        np.nextafter(grid, np.float32(-np.inf)),
                        rng.uniform(-1024, 1024, 10 ** 6).astype(np.float32)])
    q = q[np.abs(q) <= 1024]
    assert np.array_equal(_magic_round_int16(q), np.rint(q).astype(np.int16))
    # the bound: a flat 0 or 255 block at q100 (all divisors 1) reaches it
    ones = np.ones((8, 8), np.int32)
    for v, dc in ((0, -1024), (255, 1016)):
        t = _stated_sequence(np.full((1, 8, 8), v, np.uint8), ones)
        assert t[0, 0, 0, 0, 0] == dc and np.abs(t).max() == abs(dc)


@pytest.mark.parametrize("dtype", ["uint8", "float32"])
@pytest.mark.parametrize("quality", [50, 90, 100])
def test_dct8x8_quant_planes_match_reference(quality, dtype):
    """Y (2, 64, 128) with Cb and Cr (2, 32, 64), luma and chroma tables:
    float planes bit-exact to the reference's Pallas kernel in interpret
    mode, uint8 planes to the golden's stated sequence (see the module
    docstring), each plane as it would be alone."""
    rng = np.random.default_rng(200 + quality)
    shapes = ((2, 64, 128), (2, 32, 64), (2, 32, 64))
    if dtype == "uint8":
        planes = [rng.integers(0, 256, s, dtype=np.uint8) for s in shapes]
    else:
        planes = [rng.uniform(0, 255, s).astype(np.float32) for s in shapes]
    tables = [tk.jpeg_quant_table(quality)] + [tk.jpeg_quant_table(quality, chroma=True)] * 2
    got = tk.dct8x8_quant_planes([torch.from_numpy(p) for p in planes], tables)
    assert len(got) == 3
    for g, p, q in zip(got, planes, tables, strict=True):
        g = g.numpy()
        assert g.dtype == np.int16 and g.shape == (p.shape[0], p.shape[1] // 8,
                                                   p.shape[2] // 8, 8, 8)
        if dtype == "uint8":
            want = _stated_sequence(p, q)
        else:
            want = np.asarray(pk.dct8x8_quant_pallas(jnp.asarray(p), q, interpret=True))
        assert np.array_equal(g, want)
        assert np.array_equal(g, tk.dct8x8_quant(torch.from_numpy(p), q).numpy())


def test_dct8x8_quant_planes_refuses_what_it_does_not_take():
    plane = torch.zeros((1, 8, 8), dtype=torch.uint8)
    q = tk.jpeg_quant_table(90)
    for planes, tables in (([], []), ([plane] * 4, [q] * 4), ([plane, plane], [q])):
        with pytest.raises(ValueError, match="planes"):
            tk.dct8x8_quant_planes(planes, tables)
    with pytest.raises(ValueError, match="CUDA device"):
        tk.dct8x8_quant_planes([plane, plane.to("meta")], [q, q])


# -- YCbCr, probe, fused transform ---------------------------------------


@pytest.mark.parametrize("shape", [(2, 48, 64, 3), (1, 33, 47, 3), (3, 32, 63, 3)])
def test_rgb_to_ycbcr420_matches_reference(shape):
    """Bound: 1 LSB (the chroma mean and XLA's CPU contraction may round an
    ulp apart). These seeds give 0 differing samples, which is asserted."""
    x = np.random.default_rng(3).integers(0, 256, shape, dtype=np.uint8)
    want = [np.asarray(p) for p in jca.rgb_to_ycbcr420(jnp.asarray(x))]
    got = [p.numpy() for p in tca.rgb_to_ycbcr420(torch.from_numpy(x))]
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == np.uint8
        assert np.abs(g.astype(np.int16) - w).max() <= 1
        assert int((g != w).sum()) == 0
    rgb = tca.ycbcr420_to_rgb_host(*got)
    assert np.array_equal(rgb, jca.ycbcr420_to_rgb_host(*want))


def test_device_probe_matches_reference_and_host():
    rng = np.random.default_rng(4)
    frames = _stream(rng, 9)
    jp, tp = jca.DeviceDeltaProbe(tile=TILE), tca.DeviceDeltaProbe(tile=TILE)
    prev = None
    for s in (0, 3, 6):
        batch = np.stack(frames[s:s + 3])
        got = tp.bitmaps(torch.from_numpy(batch))
        assert np.array_equal(got, jp.bitmaps(jnp.asarray(batch)))
        chain = [prev if prev is not None else batch[0]] + list(batch[:-1])
        for i in range(3):
            if s == 0 and i == 0:
                assert (got[0] == 255).all()
            else:
                assert np.array_equal(got[i], jcodec.host_tile_maxdiff(
                    batch[i], chain[i], TILE))
        prev = batch[-1]


# Differing coefficients of the fused pass against the reference on this
# stream (each one a K6 rounding tie, see the module docstring).
_FUSED_DIFFS = 50


def test_fused_transform_matches_reference():
    rng = np.random.default_rng(0)
    frames = _stream(rng, 9)
    jf = jca.FusedDeltaTransform(tile=TILE, quality=90)
    tf = tca.FusedDeltaTransform(tile=TILE, quality=90)
    n_diff = 0
    for bi, s in enumerate((0, 3, 6)):
        batch = np.stack(frames[s:s + 3])
        jb, jc = jf.process(jnp.asarray(batch))
        tb, tc = tf.process(torch.from_numpy(batch))
        assert tf.calls == bi + 1
        assert np.array_equal(tb, jb)
        if bi == 0:
            assert (tb[0] == 255).all()
        for k in range(3):
            for name in ("yq", "cbq", "crq"):
                g = getattr(tc[k], name).numpy()
                w = np.asarray(getattr(jc[k], name))
                assert g.shape == w.shape and g.dtype == np.int16
                assert np.abs(g.astype(np.int32) - w).max() <= 1
                n_diff += int((g != w).sum())
    assert n_diff == _FUSED_DIFFS
    assert not tca.FusedDeltaTransform.supports((1, 40, 64, 3), 16)


# -- wire bytes ------------------------------------------------------------


@pytest.fixture
def shim_ok():
    try:
        tcodec.NativeJpegCodec(threads=1).close()
        jcodec.NativeJpegCodec(threads=1).close()
    except (RuntimeError, OSError) as e:
        pytest.skip(f"JPEG shim unavailable: {e}")


def test_native_jpeg_codec_bytes_match(shim_ok):
    rng = np.random.default_rng(5)
    frame = rng.integers(0, 256, (H, W, 3), np.uint8)
    t, j = tcodec.NativeJpegCodec(90, threads=2), jcodec.NativeJpegCodec(90, threads=2)
    try:
        blob = t.encode(frame)
        assert blob == j.encode(frame)
        assert t.probe(blob) == (H, W)
        assert np.array_equal(t.decode(blob), j.decode(blob))
        out = np.empty((2, H, W, 3), np.uint8)
        t.decode_batch([blob, j.encode(frame[::-1].copy())], out=out)
        assert np.array_equal(out[1], j.decode(j.encode(frame[::-1].copy())))
        assert [f.result() for f in t.encode_batch_async([frame])] == [blob]
        y, cb, cr = (np.asarray(p)[0] for p in jca.rgb_to_ycbcr420(jnp.asarray(frame[None])))
        assert t.encode_ycbcr420(y, cb, cr) == j.encode_ycbcr420(y, cb, cr)
        with pytest.raises(tcodec.JpegGeometryError):
            t.decode_into(blob, np.empty((H, W + 8, 3), np.uint8))
        assert t.config()["backend"] == "native"
    finally:
        t.close()
        j.close()


@pytest.mark.parametrize("inner", ["raw", "jpeg"])
def test_delta_codec_bytes_match_and_cross_decode(shim_ok, inner):
    rng = np.random.default_rng(6)
    frames = _stream(rng, 10)

    def make(mod):
        base = mod.RawCodec(H, W) if inner == "raw" else mod.NativeJpegCodec(90, threads=1)
        return mod.DeltaCodec(base, tile=TILE, keyframe_interval=4)

    te, je, td, jd = make(tcodec), make(jcodec), make(tcodec), make(jcodec)
    try:
        blobs = []
        for f in frames:
            blob_t, blob_j = te.encode(f), je.encode(f)
            assert blob_t == blob_j
            # each package decodes the other's bytes
            assert np.array_equal(td.decode(blob_j), jd.decode(blob_t))
            blobs.append(blob_t)
        assert te.stats() == je.stats()
        assert tcodec.DeltaCodec.seek_keyframe(blobs[1:]) == \
            jcodec.DeltaCodec.seek_keyframe(blobs[1:]) == 4
    finally:
        for c in (te, je, td, jd):
            c.close()


def test_coefficient_wire_bytes_match(shim_ok):
    """The same coefficient frames (the reference's fused output) through
    both packages' DeltaCodec: identical bytes; each decodes the other's,
    and the port's own fused output decodes within one JPEG generation."""
    rng = np.random.default_rng(7)
    frames = _stream(rng, 6)
    jf = jca.FusedDeltaTransform(tile=TILE, quality=90)
    jb, jc = jf.process(jnp.asarray(np.stack(frames)))
    tf = tca.FusedDeltaTransform(tile=TILE, quality=90)
    tb, tcf = tf.process(torch.from_numpy(np.stack(frames)))

    def make(mod):
        return mod.DeltaCodec(mod.NativeJpegCodec(90, threads=1), tile=TILE,
                              keyframe_interval=32)

    te, je, td, jd = make(tcodec), make(jcodec), make(tcodec), make(jcodec)
    own_enc, own_dec = make(tcodec), make(tcodec)
    try:
        out_t = np.empty((H, W, 3), np.uint8)
        out_j = np.empty((H, W, 3), np.uint8)
        own = np.empty((H, W, 3), np.uint8)
        differing = 0
        for k in range(6):
            planes = [np.asarray(getattr(jc[k], n)) for n in ("yq", "cbq", "crq")]
            cf = tcodec.CoefficientFrame(*planes, H, W, TILE, 90)
            blob = te.encode(None, bitmap=jb[k], coeffs=cf)
            assert blob == je.encode(None, bitmap=jb[k], coeffs=jc[k])
            td.decode_into(blob, out_t)
            jd.decode_into(blob, out_j)
            assert np.array_equal(out_t, out_j)
            # the port's own fused output: the same stream but for the
            # K6 tie coefficients (test_fused_transform_matches_reference)
            own_blob = own_enc.encode(None, bitmap=tb[k], coeffs=tcf[k])
            differing += own_blob != blob
            own_dec.decode_into(own_blob, own)
            assert np.abs(own.astype(int) - out_t).max() <= 8
        assert differing == 3   # of 6 payloads (K6 ties)
        s = te.stats()
        assert s["assist"] == "full-transform" and s["coef_frames"] == 6
        assert s["keyframes"] == 1 and s["d2h_coef_bytes"] > 0
        assert s == {**je.stats(), "entropy_ms": s["entropy_ms"]}
    finally:
        for c in (te, je, td, jd, own_enc, own_dec):
            c.close()
