"""The port's services over a mesh on the CPU (``mesh=`` with meshes that
name ``torch.device("cpu")`` once per shard): the mesh cases of
tests/test_serving.py. Frame-parallel and hybrid serving match the
single-device engine, the batch must be a multiple of the data axis and the
rows must divide over the space axis, the identifier splits its bank over
the data axis and refuses a space axis."""

import numpy as np
import pytest
import torch

from watermarking_gpu_tpu_torch import (DetectorService, EmbedderService,
                                        IdentifierService)
from watermarking_gpu_tpu_torch.models import BatchedWatermark, MaskType
from watermarking_gpu_tpu_torch.parallel import make_mesh

torch.set_num_threads(1)


def cpu_mesh(data: int, space: int = 1):
    return make_mesh(data, space, devices=["cpu"] * (data * space))


@pytest.fixture(scope="module")
def engine():
    rng = np.random.default_rng(4864)
    wm = rng.normal(size=(48, 64)).astype(np.float32)
    return BatchedWatermark(48, 64, wm, p=3, psnr=35.0, device="cpu")


@pytest.fixture(scope="module")
def frames():
    rng = np.random.default_rng(114864)
    return np.clip(rng.normal(128, 40, (11, 48, 64)), 0,
                   255).astype(np.float32)


def serve(service, inputs):
    try:
        return [f.result(timeout=120)
                for f in [service.submit(x) for x in inputs]]
    finally:
        service.close()


def test_multichip_serving_matches_single(engine, frames):
    """Services over a DP mesh (data=4): batches split across the shards,
    results match single-device serving; u8 frames too."""
    mesh = cpu_mesh(4)
    direct = engine.detect(frames[:8], MaskType.ME).numpy()
    got = serve(DetectorService(engine, batch_size=8, mesh=mesh), frames[:8])
    np.testing.assert_allclose(got, direct, atol=1e-4)
    u8 = frames[:4].astype(np.uint8)
    got_u8 = serve(DetectorService(engine, batch_size=4, mesh=mesh), u8)
    np.testing.assert_allclose(got_u8,
                               engine.detect(u8, MaskType.ME).numpy(),
                               atol=1e-4)
    (marked, strength), = serve(EmbedderService(engine, batch_size=4,
                                                mesh=mesh), frames[:1])
    ref_marked, ref_s = engine.embed(frames[:1], mask_type=MaskType.ME)
    np.testing.assert_allclose(marked, ref_marked[0].numpy(), atol=1e-2)
    assert strength == pytest.approx(float(ref_s[0]), rel=1e-4)

    with pytest.raises(ValueError, match="multiple of the mesh"):
        DetectorService(engine, batch_size=6, mesh=mesh)


def test_multichip_serving_generalized_me(frames):
    """A p=5 engine on the kernel route serves over a DP mesh: each shard
    runs the wide Gram's kernels (their plain versions here)."""
    wm = np.random.default_rng(5).normal(size=(48, 64)).astype(np.float32)
    eng = BatchedWatermark(48, 64, wm, p=5, psnr=35.0, device="cpu")
    direct = eng.detect(frames[:4], MaskType.ME).numpy()
    got = serve(DetectorService(eng, batch_size=4, mesh=cpu_mesh(4)),
                frames[:4])
    np.testing.assert_allclose(got, direct, atol=1e-4)


def test_identifier_service_mesh_candidate_sharding(engine, frames):
    """With a mesh, the bank splits over the data axis (each shard scores
    N/n candidates); results match single-device identification."""
    rng = np.random.default_rng(78)
    bank = np.stack(
        [engine.random_matrix.numpy()]
        + [rng.normal(size=(engine.rows, engine.cols)).astype(np.float32)
           for _ in range(7)])
    marked, _ = engine.embed(frames[:2], mask_type=MaskType.ME)
    marked = marked.numpy()
    direct = engine.detect_many(marked, bank, MaskType.ME).numpy()
    got = np.stack(serve(IdentifierService(
        engine, bank, batch_size=2, mesh=cpu_mesh(4), flush_timeout=0.01),
        marked))
    np.testing.assert_allclose(got, direct, atol=1e-4)
    assert (np.argmax(got, axis=1) == 0).all()   # the embedded candidate

    with pytest.raises(ValueError, match="divide"):
        IdentifierService(engine, bank[:6], mesh=cpu_mesh(4))
    with pytest.raises(ValueError, match="space"):
        IdentifierService(engine, bank, mesh=cpu_mesh(2, 4))


@pytest.mark.parametrize("impl", ["cuda", "torch"])
def test_spatial_mesh_serving_matches_single(frames, impl):
    """Services over a hybrid DP x SP mesh (2 x 4: frames row-split across
    the space axis, the route for frames too large for one device) match
    single-device serving."""
    wm = np.random.default_rng(4864).normal(size=(48, 64)).astype(np.float32)
    eng = BatchedWatermark(48, 64, wm, p=3, psnr=35.0, impl=impl,
                           device="cpu")
    mesh = cpu_mesh(2, 4)
    direct = eng.detect(frames[:4], MaskType.ME).numpy()
    got = serve(DetectorService(eng, batch_size=4, mesh=mesh), frames[:4])
    np.testing.assert_allclose(got, direct, atol=1e-4)
    (marked, strength), = serve(EmbedderService(eng, batch_size=2,
                                                mesh=mesh), frames[:1])
    ref_marked, ref_s = eng.embed(frames[:1], mask_type=MaskType.ME)
    np.testing.assert_allclose(marked, ref_marked[0].numpy(), atol=1e-2)
    assert strength == pytest.approx(float(ref_s[0]), rel=1e-4)

    with pytest.raises(ValueError, match="rows .* must divide"):
        DetectorService(eng, batch_size=2, mesh=cpu_mesh(1, 5))


def test_spatial_mesh_serving_wide_me(frames):
    """ME p=5 over a space mesh: an impl="torch" engine serves through the
    sharded wide Gram's plain route and matches the single-device engine;
    an impl="cuda" engine is refused when the service is built (no halo
    form of the wide Gram yet), NVF p=5 on it serves."""
    wm = np.random.default_rng(9).normal(size=(48, 64)).astype(np.float32)
    mesh = cpu_mesh(2, 4)
    eng = BatchedWatermark(48, 64, wm, p=5, psnr=35.0, impl="torch",
                           device="cpu")
    direct = eng.detect(frames[:4], MaskType.ME).numpy()
    got = serve(DetectorService(eng, batch_size=4, mesh=mesh), frames[:4])
    np.testing.assert_allclose(got, direct, atol=1e-4)
    cuda_engine = BatchedWatermark(48, 64, wm, p=5, psnr=35.0, device="cpu")
    with pytest.raises(NotImplementedError, match="impl='torch'"):
        DetectorService(cuda_engine, batch_size=4, mesh=mesh)
    got = serve(DetectorService(cuda_engine, MaskType.NVF, batch_size=4,
                                mesh=mesh), frames[:4])
    np.testing.assert_allclose(
        got, cuda_engine.detect(frames[:4], MaskType.NVF).numpy(), atol=1e-4)
