"""The port's video pipeline (``video/``) against the JAX package's, on
synthetic raw .yuv clips: the same cases as tests/test_video.py, with the
port's engines on the CPU (``device="cpu"``).

Tolerances: chroma and the frames between samples byte-exact; marked luma
may differ from the JAX package's only where the truncating u8 cast meets
a value within float noise of an integer: |delta| <= 1 on at most 1e-3 of
the bytes; correlations abs 2e-4 (the JAX suite's). The pinned-buffer
staging that the card runs is held to a synchronous embed byte for byte in
tests/test_torch_cuda.py.
"""

import io
import os

import numpy as np
import pytest
import torch

from watermarking_gpu_tpu.io.config import Settings as JaxSettings
from watermarking_gpu_tpu.video import detect_video as jax_detect_video
from watermarking_gpu_tpu.video import embed_video as jax_embed_video
from watermarking_gpu_tpu.video.pipeline import \
    _translate_encode_options as jax_translate
from watermarking_gpu_tpu_torch.io.config import Settings
from watermarking_gpu_tpu_torch.io.matfile import save_watermark
from watermarking_gpu_tpu_torch.models import BatchedWatermark, pad_to_batch
from watermarking_gpu_tpu_torch.video import (FrameReader, FrameWriter,
                                              detect_video, embed_video,
                                              frame_bytes, native_available,
                                              synthesize)
from watermarking_gpu_tpu_torch.video import libav
from watermarking_gpu_tpu_torch.video.pipeline import \
    _translate_encode_options

torch.set_num_threads(1)

W, H = 128, 96
N_FRAMES = 7
INTERVAL = 3
CORR_ATOL = 2e-4


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    rng = np.random.default_rng(253)
    root = tmp_path_factory.mktemp("video")
    path = root / "clip.yuv"
    path.write_bytes(synthesize(W, H, N_FRAMES, seed=3))
    wm_path = root / "w.dat"
    save_watermark(wm_path, rng.normal(size=(H, W)).astype(np.float32))
    return root, str(path), str(wm_path)


def make_settings(clip_path, wm_path, cls=Settings, **kw):
    s = cls(video=clip_path, watermark=wm_path, p=3, psnr=30.0,
            watermark_interval=INTERVAL, raw_video_size=f"{W}x{H}",
            raw_video_fps=25.0)
    for k, v in kw.items():
        setattr(s, k, v)
    return s


def read_frames(path) -> np.ndarray:
    data = np.frombuffer(open(path, "rb").read(), dtype=np.uint8)
    return data.reshape(-1, frame_bytes(W, H))


def lumas(frames: np.ndarray) -> np.ndarray:
    return frames[:, :W * H].reshape(-1, H, W)


def assert_passthrough(marked: np.ndarray, original: np.ndarray,
                       interval: int) -> None:
    """Chroma of every frame and the whole of each unsampled frame equal
    the input byte for byte; every sampled luma changed."""
    assert marked.shape == original.shape
    np.testing.assert_array_equal(marked[:, W * H:], original[:, W * H:])
    for i in range(len(original)):
        if i % interval:
            np.testing.assert_array_equal(marked[i], original[i])
        else:
            assert (marked[i, :W * H] != original[i, :W * H]).any(), i


class Recorder:
    """Wraps an engine method to record the shapes it is called with."""

    def __init__(self, engine, name):
        self.shapes = []
        self._fn = getattr(engine, name)
        setattr(engine, name, self)

    def __call__(self, images, *args, **kw):
        self.shapes.append(tuple(images.shape))
        return self._fn(images, *args, **kw)


@pytest.mark.parametrize("force_python", [True, False])
def test_frame_pump_roundtrip(tmp_path, force_python):
    if not force_python and not native_available():
        pytest.skip("native pump not built (make -C native)")
    rng = np.random.default_rng(12)
    fb = frame_bytes(32, 16)
    frames = [rng.integers(0, 256, fb).astype(np.uint8) for _ in range(5)]
    path = tmp_path / "pump.yuv"
    with open(path, "wb") as f:
        writer = FrameWriter(f.fileno(), fb, force_python=force_python)
        for frame in frames:
            writer.put(frame)
        writer.close()
    with open(path, "rb") as f:
        reader = FrameReader(f.fileno(), fb, force_python=force_python)
        for frame in frames:
            np.testing.assert_array_equal(reader.next(), frame)
        assert reader.next() is None
        reader.close()


def test_embed_then_detect_matches_jax(clip):
    """Embed at interval 3 and detect the marked and the clean clip, with
    both packages on the same clip and watermark."""
    root, clip_path, wm_path = clip
    original = read_frames(clip_path)
    outputs = {}
    for name, embed, cls, kw in (
            ("jax", jax_embed_video, JaxSettings, {}),
            ("port", embed_video, Settings, {"device": "cpu"})):
        out_path = str(root / f"marked_{name}.yuv")
        stats = {}
        settings = make_settings(clip_path, wm_path, cls=cls,
                                 encode_watermark_file_path=out_path)
        assert embed(settings, out=io.StringIO(), stats=stats,
                     **kw) == N_FRAMES
        outputs[name] = out_path
        assert stats["frames"] == N_FRAMES and stats["batches"] == 1
    port, jax = read_frames(outputs["port"]), read_frames(outputs["jax"])
    assert_passthrough(port, original, INTERVAL)
    delta = np.abs(lumas(port).astype(int) - lumas(jax).astype(int))
    assert delta.max() <= 1 and (delta > 0).mean() <= 1e-3

    corrs = {}
    for name, path in (("marked", outputs["port"]), ("clean", clip_path)):
        buf, stats = io.StringIO(), {}
        n, corrs[name] = detect_video(
            make_settings(path, wm_path, detect_batch=2), out=buf,
            stats=stats, device="cpu")
        assert n == N_FRAMES and stats["batches"] == 2
        assert [i for i, _ in corrs[name]] == [0, 3, 6]
        assert "Correlation for frame: 3:" in buf.getvalue()
        _, want = jax_detect_video(
            make_settings(outputs["jax"] if name == "marked" else path,
                          wm_path, cls=JaxSettings, detect_batch=2),
            out=io.StringIO())
        np.testing.assert_allclose([c for _, c in corrs[name]],
                                   [c for _, c in want], atol=CORR_ATOL)
    assert all(c > 0.4 for _, c in corrs["marked"])
    assert all(abs(c) < 0.2 for _, c in corrs["clean"])


def test_embed_interval_one_batched(clip, tmp_path):
    """interval=1 watermarks every frame in batches of embed_batch, the
    remainder padded to the same shape (7 = 4 + 3 padded)."""
    root, clip_path, wm_path = clip
    out_path = str(tmp_path / "marked_all.yuv")
    engine = BatchedWatermark(H, W, wm_path, p=3, psnr=30.0, device="cpu")
    calls = Recorder(engine, "embed_luma_u8")
    settings = make_settings(clip_path, wm_path, watermark_interval=1,
                             embed_batch=4,
                             encode_watermark_file_path=out_path)
    assert embed_video(settings, engine=engine,
                       out=io.StringIO()) == N_FRAMES
    assert calls.shapes == [(4, H, W)] * 2
    original = read_frames(clip_path)
    marked = read_frames(out_path)
    assert_passthrough(marked, original, 1)
    # each frame's luma is the one a direct embed of it gives
    want, _ = engine.embed_luma_u8(pad_to_batch(lumas(original)[4:], 4))
    np.testing.assert_array_equal(lumas(marked)[4:], want[:3].numpy())

    _, results = detect_video(make_settings(out_path, wm_path,
                                            watermark_interval=1,
                                            detect_batch=4),
                              out=io.StringIO(), device="cpu")
    assert len(results) == N_FRAMES
    assert all(c > 0.4 for _, c in results)


def test_detect_remainder_batch(clip):
    """The final partial batch pads to the (B, H, W) shape; its frames'
    correlations equal a detect of them alone."""
    root, clip_path, wm_path = clip
    engine = BatchedWatermark(H, W, wm_path, p=3, psnr=30.0, device="cpu")
    calls = Recorder(engine, "detect")
    settings = make_settings(clip_path, wm_path, watermark_interval=1,
                             detect_batch=4)
    n, results = detect_video(settings, engine=engine, out=io.StringIO())
    assert n == N_FRAMES and [i for i, _ in results] == list(range(7))
    assert calls.shapes == [(4, H, W)] * 2
    tail = engine.detect(lumas(read_frames(clip_path))[4:]).numpy()
    np.testing.assert_allclose([c for _, c in results[4:]], tail,
                               atol=1e-6)


def test_video_p5_matches_jax(clip):
    """The video path at p=5 (the generalized ME predictor) against the
    JAX pipeline's correlations on the same marked clip."""
    root, clip_path, wm_path = clip
    out_path = str(root / "marked_p5.yuv")
    embed_video(make_settings(clip_path, wm_path, p=5,
                              encode_watermark_file_path=out_path),
                out=io.StringIO(), device="cpu")
    _, got = detect_video(make_settings(out_path, wm_path, p=5,
                                        detect_batch=2),
                          out=io.StringIO(), device="cpu")
    _, want = jax_detect_video(make_settings(out_path, wm_path, p=5,
                                             cls=JaxSettings,
                                             detect_batch=2),
                               out=io.StringIO())
    assert all(c > 0.25 for _, c in got)
    np.testing.assert_allclose([c for _, c in got], [c for _, c in want],
                               atol=CORR_ATOL)


def test_missing_raw_size_errors(clip):
    root, clip_path, wm_path = clip
    with pytest.raises(RuntimeError, match="raw_video_size"):
        detect_video(make_settings(clip_path, wm_path, raw_video_size=""),
                     out=io.StringIO(), device="cpu")


def test_odd_dimensions_rejected(clip):
    root, clip_path, wm_path = clip
    with pytest.raises(RuntimeError, match="even frame dimensions"):
        detect_video(make_settings(clip_path, wm_path,
                                   raw_video_size="127x95"),
                     out=io.StringIO(), device="cpu")


@pytest.mark.parametrize("options,codec,pairs", [
    ("-c:v libx265 -preset fast -crf 23", "libx265", "preset=fast,crf=23"),
    ("", None, ""),
    ("-vcodec mpeg4 -q:v 3", "mpeg4", "q:v=3"),
    ("-c:v mpeg4 -qmin -1 -an -crf 23", "mpeg4", "qmin=-1,crf=23"),
    ("-vcodec -an -crf 23", None, "crf=23")])
def test_translate_encode_options(options, codec, pairs, capsys):
    assert _translate_encode_options(options) == (codec, pairs)
    port_out = capsys.readouterr().out
    assert jax_translate(options) == (codec, pairs)
    assert capsys.readouterr().out == port_out


@pytest.fixture()
def fake_ffmpeg(tmp_path, clip, monkeypatch):
    """Stub ffmpeg/ffprobe binaries that speak just enough of the CLI."""
    root, clip_path, wm_path = clip
    ffmpeg = tmp_path / "ffmpeg"
    ffmpeg.write_text(f"""#!/bin/bash
# decode mode: ... -i <file> -f rawvideo -pix_fmt yuv420p -
if [[ "$*" == *"-f rawvideo -pix_fmt yuv420p -" ]]; then
    cat "{clip_path}"
    exit 0
fi
# encode mode: -f rawvideo ... -i - -i <src> ... <out>; raw video on stdin
out="${{@: -1}}"
cat > "$out"
""")
    ffmpeg.chmod(0o755)
    ffprobe = tmp_path / "ffprobe"
    ffprobe.write_text(f"""#!/bin/bash
echo '{{"streams": [{{"width": {W}, "height": {H}, "avg_frame_rate": "25/1", "pix_fmt": "yuv420p"}}]}}'
""")
    ffprobe.chmod(0o755)
    monkeypatch.setenv("WM_FFMPEG", str(ffmpeg))
    monkeypatch.setenv("WM_FFPROBE", str(ffprobe))
    # the subprocess plumbing is under test; the in-process libav path
    # (which outranks it) would reject the fake "input.mp4"
    monkeypatch.setenv("WM_NO_INPROC_VIDEO", "1")
    return root, clip_path, wm_path


def test_ffmpeg_subprocess_path(fake_ffmpeg, tmp_path, capsys):
    """Probe, decode pipe and encode pipe through stub binaries: the
    encoder receives exactly the stream the raw-yuv sink writes, and
    detection reads through the decoder pipe."""
    root, clip_path, wm_path = fake_ffmpeg
    out_path = str(tmp_path / "marked.mp4")
    settings = make_settings("input.mp4", wm_path, raw_video_size="",
                             encode_watermark_file_path=out_path)
    assert embed_video(settings, out=io.StringIO(),
                       device="cpu") == N_FRAMES
    echoed = capsys.readouterr().out
    assert "FFmpeg encode command:" in echoed and "-pix_fmt yuv420p" in echoed
    raw_out = str(tmp_path / "marked_ref.yuv")
    embed_video(make_settings(clip_path, wm_path,
                              encode_watermark_file_path=raw_out),
                out=io.StringIO(), device="cpu")
    assert open(out_path, "rb").read() == open(raw_out, "rb").read()

    ffmpeg = os.environ["WM_FFMPEG"]
    text = open(ffmpeg).read().replace(clip_path, out_path)
    open(ffmpeg, "w").write(text)
    n, results = detect_video(make_settings("input.mp4", wm_path,
                                            raw_video_size=""),
                              out=io.StringIO(), device="cpu")
    assert n == N_FRAMES
    assert all(c > 0.4 for _, c in results)


def test_inproc_libav_round_trip(tmp_path, clip):
    """In-process libav: a lossless ffv1 clip decodes bit-exactly, and the
    video embed-then-detect runs through it with no ffmpeg binary."""
    if not libav.available():
        pytest.skip("native/libwmdecode.so does not load (make -C native)")
    if not libav.codec_available("ffv1"):
        pytest.skip("ffv1 encoder not in this libavcodec")
    root, _, wm_path = clip
    fb = frame_bytes(W, H)
    raw = synthesize(W, H, N_FRAMES, seed=3)
    src_path = str(tmp_path / "src.mkv")
    encoder = libav.LibavEncoder(src_path, W, H, 25.0, "ffv1")
    for i in range(N_FRAMES):
        encoder.write(raw[i * fb:(i + 1) * fb])
    encoder.close()
    decoder = libav.LibavDecoder(src_path)
    assert (decoder.width, decoder.height, decoder.pix_fmt) == (W, H,
                                                                "yuv420p")
    decoded = []
    while (frame := decoder.read()) is not None:
        decoded.append(frame)
    decoder.close()
    assert b"".join(f.tobytes() for f in decoded) == raw

    marked_path = str(tmp_path / "marked.mkv")
    settings = make_settings(src_path, wm_path, raw_video_size="",
                             encode_watermark_file_path=marked_path,
                             encode_options="-c:v ffv1 -level 3")
    assert embed_video(settings, out=io.StringIO(),
                       device="cpu") == N_FRAMES
    _, results = detect_video(make_settings(marked_path, wm_path,
                                            raw_video_size=""),
                              out=io.StringIO(), device="cpu")
    assert len(results) == 3 and all(c > 0.4 for _, c in results)
