"""The port's ``parallel/`` on the CPU against the JAX package's.

The port's meshes name ``torch.device("cpu")`` once per shard, as the JAX
package's tests use its 8 virtual CPU devices (``tests/conftest.py``); the
JAX side runs ``impl="xla"``. Both get the same numpy inputs. The port's
``impl="cuda"`` route runs the kernels' plain halo forms here (the kernels
themselves are held to them on the card: ``tests/test_torch_cuda.py``).
Tolerances: those of ``tests/test_parallel.py`` (correlations 1e-4 to
2e-4, strengths 1e-4 relative, pixels 2e-3), and for the 1080-row case
the JAX package's own multi-device bounds (``__graft_entry__.py``: pixels
1e-2, strengths 5e-3 relative, correlations 5e-4).
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec

import watermarking_gpu_tpu.parallel as jp
import watermarking_gpu_tpu_torch.parallel as tp
from watermarking_gpu_tpu.ops import strength_factor
from watermarking_gpu_tpu_torch.ops import cuda as kernels
from watermarking_gpu_tpu_torch.ops.cuda.fused import stencil_reach
from watermarking_gpu_tpu_torch.ops.neighbors import pad_edge
from watermarking_gpu_tpu_torch.ops.pipelines import (detect_pipeline,
                                                      embed_pipeline)

torch.set_num_threads(2)

SF = strength_factor(40.0)
ROWS, COLS = 32, 256
IMPLS = ("torch", "cuda")


def port_mesh(data: int = 1, space: int = 1) -> tp.Mesh:
    return tp.make_mesh(data, space, devices=["cpu"] * (data * space))


@pytest.fixture(scope="module")
def frames():
    rng = np.random.default_rng(83264)
    return np.clip(rng.normal(128.0, 40.0, size=(8, ROWS, COLS)), 0,
                   255).astype(np.float32)


@pytest.fixture(scope="module")
def watermark():
    return np.random.default_rng(3264).normal(
        size=(ROWS, COLS)).astype(np.float32)


@pytest.fixture(scope="module")
def bank(watermark):
    rng = np.random.default_rng(99)
    return np.stack([watermark] + [rng.normal(size=watermark.shape)
                                   for _ in range(7)]).astype(np.float32)


def test_mesh_and_exports():
    """The 17 names of the JAX package's parallel/ (and the port's mesh
    and sharded-value types); the mesh's shape and its errors."""
    assert set(jp.__all__) <= set(tp.__all__)
    assert (tp.DATA_AXIS, tp.SPACE_AXIS) == (jp.DATA_AXIS, jp.SPACE_AXIS)
    mesh = port_mesh(2, 4)
    assert mesh.shape == {"data": 2, "space": 4}
    assert mesh.shape["data"] == 2 and dict(mesh.shape).get("space") == 4
    assert all(d == torch.device("cpu") for row in mesh.devices for d in row)
    assert tp.make_mesh(space=2, devices=["cpu"] * 7).shape["data"] == 3
    with pytest.raises(ValueError, match="needs more than 8 devices"):
        tp.make_mesh(3, 3, devices=["cpu"] * 8)
    if not torch.cuda.is_available():   # devices=None: the visible cards
        with pytest.raises(ValueError, match="needs more than 0 devices"):
            tp.make_mesh(1)
    sharded = tp.shard(mesh, np.arange(2 * 8 * 3).reshape(2, 8, 3),
                       (tp.DATA_AXIS, tp.SPACE_AXIS))
    assert sharded.shards[1][3].shape == (1, 2, 3)
    np.testing.assert_array_equal(np.asarray(sharded),
                                  np.arange(48).reshape(2, 8, 3))
    with pytest.raises(ValueError, match="does not divide"):
        tp.shard_rows(mesh, np.zeros((6, 3)))


@pytest.mark.parametrize("halo", [3, 4, 9, 11])
def test_exchange_row_halo_multi_hop_values(halo):
    """Within one shard (3 < 4 rows), exactly one shard (4), deep multi-hop
    (9, 11): every shard's extended block equals the JAX package's, and the
    rows of the edge-replicated frame."""
    n, h_local, w = 8, 4, 16
    img = np.arange(n * h_local * w, dtype=np.float32).reshape(-1, w) + 1.0
    mesh = jp.make_mesh(data=1, space=n)
    fn = jax.jit(jax.shard_map(
        partial(jp.exchange_row_halo, halo=halo), mesh=mesh,
        in_specs=(PartitionSpec(jp.SPACE_AXIS, None),),
        out_specs=PartitionSpec(jp.SPACE_AXIS, None), check_vma=False))
    want = np.asarray(fn(jp.shard_rows(mesh, jnp.asarray(img)))).reshape(
        n, h_local + 2 * halo, w)
    got = tp.exchange_row_halo(list(torch.from_numpy(img).chunk(n)), halo)
    padded = np.pad(img, [(halo, halo), (0, 0)], mode="edge")
    for i in range(n):
        np.testing.assert_array_equal(got[i].numpy(), want[i])
        np.testing.assert_array_equal(
            got[i].numpy(), padded[i * h_local:(i + 1) * h_local + 2 * halo])


@pytest.mark.parametrize("impl", IMPLS)
def test_dp_detect_and_embed_match_jax(frames, watermark, impl):
    """Frame-parallel detect (ME, and ME p=5: the wide Gram per shard on
    the kernel route too) and embed (NVF) over data=8."""
    jmesh, mesh = jp.make_mesh(data=8), port_mesh(8)
    jframes = jp.shard_frames(jmesh, jnp.asarray(frames))
    jwm = jp.replicate(jmesh, jnp.asarray(watermark))
    for p in (3, 5):
        want = jp.make_dp_detect(jmesh, "me", p=p)(jframes, jwm)
        got = tp.make_dp_detect(mesh, "me", p=p, impl=impl)(
            tp.shard_frames(mesh, frames), tp.replicate(mesh, watermark))
        assert got.spec == (tp.DATA_AXIS,)
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   atol=1e-4)
    want_out, want_s = jp.make_dp_embed(jmesh, "nvf", SF)(jframes, jframes,
                                                          jwm)
    got_out, got_s = tp.make_dp_embed(mesh, "nvf", SF, impl=impl)(
        frames, frames, watermark)
    np.testing.assert_allclose(np.asarray(got_out), np.asarray(want_out),
                               atol=1e-3)
    np.testing.assert_allclose(np.asarray(got_s), np.asarray(want_s),
                               rtol=1e-5)


@pytest.mark.parametrize("impl", IMPLS)
def test_dp_detect_many_matches_jax(frames, watermark, bank, impl):
    """The bank split 2 candidates a shard over data=4; the embedded
    candidate wins; batched (B, H, W) images too."""
    marked, _ = embed_pipeline(torch.from_numpy(frames[0]),
                               torch.from_numpy(frames[0]),
                               torch.from_numpy(watermark), SF, "me",
                               impl="torch")
    marked = marked.numpy()
    jmesh, mesh = jp.make_mesh(data=4), port_mesh(4)
    want = jp.make_dp_detect_many(jmesh, "me")(
        jp.replicate(jmesh, jnp.asarray(marked)),
        jp.shard_frames(jmesh, jnp.asarray(bank)))
    got = np.asarray(tp.make_dp_detect_many(mesh, "me", impl=impl)(
        marked, bank))
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-4)
    assert int(np.argmax(got)) == 0
    imgs = np.stack([marked, frames[1]])
    want_b = jp.make_dp_detect_many(jmesh, "me", batched=True)(
        jp.replicate(jmesh, jnp.asarray(imgs)),
        jp.shard_frames(jmesh, jnp.asarray(bank)))
    got_b = tp.make_dp_detect_many(mesh, "me", impl=impl, batched=True)(
        imgs, bank)
    assert got_b.spec == (None, tp.DATA_AXIS)
    np.testing.assert_allclose(np.asarray(got_b), np.asarray(want_b),
                               atol=1e-4)


def jax_spatial(mask_type, p, space, img, wm):
    """The JAX package's spatial detect and embed (impl="xla")."""
    mesh = jp.make_mesh(data=1, space=space)
    img_sh, wm_sh = jp.shard_rows(mesh, img), jp.shard_rows(mesh, wm)
    corr = jp.make_spatial_detect(mesh, mask_type, p=p)(img_sh, wm_sh)
    out, strength = jp.make_spatial_embed(mesh, mask_type, SF, *img.shape,
                                          p=p)(img_sh, img_sh, wm_sh)
    return float(corr), np.asarray(out), float(strength)


def assert_spatial_matches(mask_type, p, space, img, wm, impl,
                           corr_atol=2e-4, strength_rtol=1e-4,
                           pixel_atol=2e-3):
    want_corr, want_out, want_s = jax_spatial(mask_type, p, space,
                                              jnp.asarray(img),
                                              jnp.asarray(wm))
    mesh = port_mesh(1, space)
    got = tp.make_spatial_detect(mesh, mask_type, p=p, impl=impl)(
        tp.shard_rows(mesh, img), tp.shard_rows(mesh, wm))
    assert abs(float(got) - want_corr) <= corr_atol
    got_out, got_s = tp.make_spatial_embed(mesh, mask_type, SF, p=p,
                                           impl=impl)(img, img, wm)
    assert got_out.spec[0] == tp.SPACE_AXIS
    assert float(got_s) == pytest.approx(want_s, rel=strength_rtol)
    np.testing.assert_allclose(np.asarray(got_out), want_out,
                               atol=pixel_atol)


@pytest.mark.parametrize("mask_type,p,space,impl", [
    ("me", 3, 8, "torch"), ("me", 3, 8, "cuda"), ("nvf", 3, 8, "torch"),
    ("nvf", 3, 8, "cuda"), ("nvf", 5, 4, "torch"), ("nvf", 5, 4, "cuda"),
    ("me", 5, 4, "torch")])
def test_spatial_matches_jax(frames, watermark, mask_type, p, space, impl):
    """Row-sharded detect and embed: ME and NVF at p=3 on 4-row shards,
    the NVF p=5 halo (3 rows for the detect tail) and ME p=5 (the sharded
    lag form of the wide Gram)."""
    assert_spatial_matches(mask_type, p, space, frames[0], watermark, impl)


@pytest.mark.parametrize("impl", IMPLS)
def test_spatial_halo_deeper_than_shard(frames, watermark, impl):
    """NVF p=9 on 4-row shards: the detect tail's 5-row halo gathers whole
    neighbour blocks over two hops."""
    assert_spatial_matches("nvf", 9, 8, frames[0], watermark, impl)


def test_wide_me_p9_shards(frames, watermark):
    """ME p=9 (h = 4) on 4-row shards (the wide Gram's bank rows and its
    2h lag reach span several shards: multi-hop exchanges) and on 8-row
    shards (2h rows, < 3h), on the plain route; the frame's lag form
    throughout, as the JAX package's shard analysis keeps it."""
    img, wm = jnp.asarray(frames[0]), jnp.asarray(watermark)
    jmesh = jp.make_mesh(data=1, space=8)
    want = float(jp.make_spatial_detect(jmesh, "me", p=9)(
        jp.shard_rows(jmesh, img), jp.shard_rows(jmesh, wm)))
    got = tp.make_spatial_detect(port_mesh(1, 8), "me", p=9, impl="torch")(
        frames[0], watermark)
    assert abs(float(got) - want) <= 1e-4
    assert_spatial_matches("me", 9, 4, frames[0], watermark, "torch",
                           strength_rtol=1e-3)


@pytest.mark.parametrize("impl", IMPLS)
def test_hybrid_matches_jax(frames, watermark, impl):
    """A 2 x 4 mesh: frames over data, rows over space, ME detect and
    embed."""
    jmesh, mesh = jp.make_mesh(data=2, space=4), port_mesh(2, 4)
    jframes = jp.shard_hybrid(jmesh, jnp.asarray(frames))
    jwm = jp.shard_watermark(jmesh, jnp.asarray(watermark))
    want = jp.make_hybrid_detect(jmesh, "me")(jframes, jwm)
    got = tp.make_hybrid_detect(mesh, "me", impl=impl)(
        tp.shard_hybrid(mesh, frames), tp.shard_watermark(mesh, watermark))
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=2e-4)
    want_out, want_s = jp.make_hybrid_embed(jmesh, "me", SF, ROWS, COLS)(
        jframes, jframes, jwm)
    got_out, got_s = tp.make_hybrid_embed(mesh, "me", SF, impl=impl)(
        frames, frames, watermark)
    assert got_out.spec == (tp.DATA_AXIS, tp.SPACE_AXIS, None)
    np.testing.assert_allclose(np.asarray(got_s), np.asarray(want_s),
                               rtol=1e-4)
    np.testing.assert_allclose(np.asarray(got_out), np.asarray(want_out),
                               atol=2e-3)


@pytest.mark.parametrize("impl", IMPLS)
def test_spatial_embed_rgb_channels(frames, watermark, impl):
    """Row-sharded embed into an RGB output."""
    img = frames[0]
    rgb = np.repeat(img[..., None], 3, axis=-1)
    jmesh, mesh = jp.make_mesh(data=1, space=4), port_mesh(1, 4)
    want_out, want_s = jp.make_spatial_embed(
        jmesh, "me", SF, ROWS, COLS, channels=True)(
        jp.shard_rows(jmesh, jnp.asarray(img)),
        jp.shard_rows(jmesh, jnp.asarray(rgb)),
        jp.shard_rows(jmesh, jnp.asarray(watermark)))
    got_out, got_s = tp.make_spatial_embed(mesh, "me", SF, channels=True,
                                           impl=impl)(
        img, rgb, watermark)
    assert np.asarray(got_out).shape == rgb.shape
    assert float(got_s) == pytest.approx(float(want_s), rel=1e-4)
    np.testing.assert_allclose(np.asarray(got_out), np.asarray(want_out),
                               atol=2e-3)


@pytest.mark.parametrize("mask_type", ["me", "nvf"])
def test_mesh_detect_many_matches_jax(frames, watermark, bank, mask_type):
    """Identification over a 2 x 4 mesh (rows over space, candidates over
    data) at p = 3 and 5, and batched: the embedded candidate wins."""
    marked, _ = embed_pipeline(torch.from_numpy(frames[0]),
                               torch.from_numpy(frames[0]),
                               torch.from_numpy(watermark), SF, mask_type,
                               impl="torch")
    marked = marked.numpy()
    jmesh, mesh = jp.make_mesh(data=2, space=4), port_mesh(2, 4)
    jbank = jp.shard_hybrid(jmesh, jnp.asarray(bank))
    for p in (3, 5):
        want = jp.make_mesh_detect_many(jmesh, mask_type, p=p)(
            jp.shard_rows(jmesh, jnp.asarray(marked)), jbank)
        got = np.asarray(tp.make_mesh_detect_many(
            mesh, mask_type, p=p, impl="torch")(marked, bank))
        np.testing.assert_allclose(got, np.asarray(want), atol=1e-4)
        assert int(np.argmax(got)) == 0
    imgs = np.stack([marked, frames[1]])
    want_b = jp.make_mesh_detect_many(jmesh, mask_type, batched=True)(
        jax.device_put(jnp.asarray(imgs), NamedSharding(
            jmesh, PartitionSpec(None, jp.SPACE_AXIS, None))), jbank)
    got_b = tp.make_mesh_detect_many(mesh, mask_type, impl="torch",
                                     batched=True)(imgs, bank)
    np.testing.assert_allclose(np.asarray(got_b), np.asarray(want_b),
                               atol=1e-4)


def test_1080_rows_270_row_shards(watermark):
    """A 1080 x 384 frame over 4 shards of 270 rows (the card's shard
    height), ME p=3 on the kernel route's plain halo forms."""
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:1080, 0:384].astype(np.float32)
    img = np.clip(110 + 70 * np.sin(xx / 9.0) * np.cos(yy / 7.0)
                  + rng.normal(0, 14, (1080, 384)), 0, 255).astype(np.float32)
    wm = rng.normal(size=(1080, 384)).astype(np.float32)
    assert_spatial_matches("me", 3, 4, img, wm, "cuda", corr_atol=5e-4,
                           strength_rtol=5e-3, pixel_atol=1e-2)


def extended(frames: torch.Tensor, start: int, stop: int, halo: int):
    """Rows [start - halo, stop + halo) of the edge-replicated frames (a
    shard as the exchange extends it)."""
    rows = pad_edge(frames, halo)[..., halo:-halo]
    return rows[..., start:stop + 2 * halo, :].contiguous()


@pytest.mark.parametrize("bounds", [(0, 8, 16, 24, 32), (0, 16, 32)])
@pytest.mark.parametrize("mask_type,p", [("me", 3), ("me", 5), ("nvf", 3),
                                         ("nvf", 9)])
def test_halo_plain_forms_sum_to_frame(frames, watermark, bounds, mask_type,
                                       p):
    """The kernels' plain halo forms per shard (top, interior, bottom)
    against the unsharded plain versions: the 3x3 Gram's lag sums, its
    assembly and the direct Gram summed (at the detect tail's halo and at
    the embed field's, which the embed route gives the Gram), the embed
    field's u_raw joined (bit-equal) and its sums, the detect tail's sums
    summed; with no halo each is the unsharded function exactly."""
    img = torch.from_numpy(frames[:2])
    wm = torch.from_numpy(watermark)
    pred_p = p if mask_type == "me" else 3
    k = pred_p * pred_p - 1
    coeffs = torch.from_numpy(np.random.default_rng(p).normal(
        0, 0.05, (2, k)).astype(np.float32))
    gram = kernels.me_gram_plain(img)
    u_raw, sum_u2, max_e = kernels.embed_field_plain(img, wm, coeffs,
                                                     mask_type, p)
    detect = kernels.detect_partials_plain(img, wm, coeffs, mask_type, p)
    reach = stencil_reach(mask_type, p)
    shards = list(zip(bounds, bounds[1:]))
    half = max(1, p // 2)
    grams = {halo: ([], []) for halo in {half, reach}}
    fields, sums = [], []
    for start, stop in shards:
        ext = extended(img, start, stop, reach)
        for halo, (direct, lag) in grams.items():
            e_ext = extended(img, start, stop, halo)
            direct.append(kernels.me_gram(e_ext, halo, halo, start, ROWS))
            lag.append(kernels.me_gram_assemble(
                kernels.me_gram_lags(e_ext, halo, halo, start, ROWS), e_ext,
                halo, halo, start, ROWS))
        fields.append(kernels.embed_field(
            extended(img, start, stop, half), wm[start:stop], coeffs,
            mask_type, p, half, half))
        sums.append(kernels.detect_partials(
            ext, extended(wm, start, stop, reach), coeffs, mask_type, p,
            reach, reach, start, ROWS))
    for got in (sum(parts) for pair in grams.values() for parts in pair):
        torch.testing.assert_close(got, gram, rtol=1e-5, atol=0)
    assert torch.equal(torch.cat([f[0] for f in fields], dim=1), u_raw)
    torch.testing.assert_close(sum(f[1] for f in fields), sum_u2, rtol=1e-5,
                               atol=0)
    assert torch.equal(torch.stack([f[2] for f in fields]).amax(0), max_e)
    for got, want in zip(zip(*sums), detect):
        torch.testing.assert_close(sum(got), want, rtol=1e-5, atol=0)
    # no halo: the frame itself
    assert torch.equal(kernels.me_gram(img, 0, 0), gram)
    assert torch.equal(kernels.embed_field(img, wm, coeffs, mask_type, p,
                                           0, 0)[0], u_raw)
    assert all(torch.equal(a, b) for a, b in zip(
        kernels.detect_partials(img, wm, coeffs, mask_type, p, 0, 0, 0,
                                ROWS), detect))


def test_halo_arguments_checked(frames, watermark):
    """The wrappers raise on what the kernels do not take: a seam with a
    shorter halo than the detect tail reads, negative halos, rows outside
    the frame, a watermark without the image's halo rows."""
    img = torch.from_numpy(frames[:1])
    wm = torch.from_numpy(watermark)
    coeffs = torch.zeros(1, 8)
    ext = extended(img, 8, 16, 1)
    with pytest.raises(ValueError, match="needs 2 rows of halo"):
        kernels.detect_partials(ext, extended(wm, 8, 16, 1), coeffs, "me",
                                3, 1, 1, 8, ROWS)
    with pytest.raises(ValueError, match="needs 1 rows of halo for the 3x3"):
        kernels.me_gram(img[:, 8:16], 0, 0, 8, ROWS)
    with pytest.raises(ValueError, match="needs 1 rows of halo for the 3x3"):
        kernels.me_gram_lags(extended(img, 0, 8, 1)[:, :-1], 1, 0, 0, ROWS)
    with pytest.raises(ValueError, match=">= 0"):
        kernels.me_gram(ext, -1, 3)
    with pytest.raises(ValueError, match="do not lie"):
        kernels.detect_partials(ext, extended(wm, 8, 16, 1), coeffs, "me",
                                3, 1, 1, 28, ROWS)
    with pytest.raises(ValueError, match="holds no owned row"):
        kernels.embed_field(ext, wm[8:16], coeffs, "me", 3, 5, 5)


def test_cuda_route_raises_where_no_halo_kernel(frames, watermark):
    """impl="cuda" at ME p > 3 over several space shards, and
    identification over several space shards, need halo forms of the wide
    Gram and the multi-candidate kernel: they raise, naming them, instead
    of taking the plain route. One space shard, and the DP route, run."""
    mesh = port_mesh(2, 2)
    for make in (partial(tp.make_spatial_detect, mesh, "me", 5),
                 partial(tp.make_spatial_embed, mesh, "me", SF, 5),
                 partial(tp.make_hybrid_detect, mesh, "me", 7),
                 partial(tp.make_hybrid_embed, mesh, "me", SF, 9)):
        with pytest.raises(NotImplementedError, match="me_gram_wide.cu"):
            make(impl="cuda")
        make(impl="torch")
    with pytest.raises(NotImplementedError, match="detect_many.cu"):
        tp.make_mesh_detect_many(mesh, "nvf", impl="cuda")
    one_row = port_mesh(2, 1)
    got = tp.make_hybrid_detect(one_row, "me", 5, impl="cuda")(
        frames[:2], watermark)
    want = detect_pipeline(torch.from_numpy(frames[:2]),
                           torch.from_numpy(watermark), "me", 5,
                           impl="torch")
    np.testing.assert_allclose(np.asarray(got), want.numpy(), atol=1e-4)
