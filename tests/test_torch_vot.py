"""tracking/vot.py of the port against the JAX package's: region parse,
encode and convert, the file protocol, and the native TraX handle over
injected streams, message for message. Then `track-vot --vot_mode trax`
end to end: the port's CLI in a subprocess on the CPU, driven over pipes
by a client built on the port's trax_protocol, whose stdout must carry
nothing but protocol lines (a stray print, such as a kernel build log,
would corrupt the wire), and whose regions equal the in-process
StreamingTracker's."""

import io
import os
import subprocess
import sys

import numpy as np
import pytest
from PIL import Image

from ntm_tracker_tpu.tracking import vot as jvot
from ntm_tracker_tpu_torch import cli
from ntm_tracker_tpu_torch.tracking import vot as tvot
from ntm_tracker_tpu_torch.tracking.trax_protocol import format_message, parse_message

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL = ["--mem_size", "16", "--mem_dim", "8", "--hidden_size", "24", "--read_head_size", "2"]
REGION0 = (30.0, 20.0, 20.0, 15.0)

REGIONS = ["1,2,3,4", "1.5,2.25,10,20", "0,0,10,0,10,10,0,10", "1,2,3,4,5,6", "1,2,3", "1,2,3,4,5"]


@pytest.mark.parametrize("text", REGIONS)
def test_parse_encode_convert_match_jax(text):
    got, want = tvot.parse_region(text), jvot.parse_region(text)
    assert (got is None) == (want is None)
    if got is None:
        return
    assert tuple(got) == tuple(want) or got.points == want.points
    assert tvot.encode_region(got) == jvot.encode_region(want)
    for to in ("rectangle", "polygon", "mask"):
        g, w = tvot.convert_region(got, to), jvot.convert_region(want, to)
        assert (g is None) == (w is None)
        if g is not None:
            assert tvot.encode_region(g) == jvot.encode_region(w)
    assert tvot.encode_region(None) == jvot.encode_region(None) == ""


def _frames(root, n=4, hw=(60, 80)):
    rng = np.random.RandomState(2)
    names = []
    for i in range(n):
        arr = (rng.rand(*hw, 3) * 255).astype(np.uint8)
        arr[20:35, 30:50] = 230
        name = f"{i:08d}.png"
        Image.fromarray(arr).save(os.path.join(root, name))
        names.append(name)
    return names


def test_file_protocol_matches_jax(tmp_path):
    names = _frames(str(tmp_path))
    (tmp_path / "images.txt").write_text("\n".join(names) + "\n")
    (tmp_path / "region.txt").write_text("0,0,10,0,10,10,0,10")
    outputs = []
    for mod in (tvot, jvot):
        handle = mod.VOT("rectangle", workdir=str(tmp_path), mode="file")
        seen = [handle.frame()]
        r = handle.region()
        for _ in range(len(names) - 1):
            handle.report(mod.Rectangle(r.x + 1, r.y, r.width, r.height))
            seen.append(handle.frame())
        handle.report(r)
        assert handle.frame() is None
        handle.quit()
        outputs.append((seen, (tmp_path / "output.txt").read_text(), tuple(r)))
    assert outputs[0] == outputs[1]
    assert outputs[0][0][0] == str(tmp_path / names[0])


def test_native_trax_handle_matches_jax():
    client = ('@@TRAX:initialize "file:///a/0.jpg" "1,2,3,4"\n'
              "@@TRAX:frame /a/1.jpg\n@@TRAX:frame /a/2.jpg\n@@TRAX:quit\n")
    outs = []
    for mod in (tvot, jvot):
        fout = io.StringIO()
        handle = mod.VOT("rectangle", mode="trax", trax_streams=(io.StringIO(client), fout))
        images = [handle.frame()]
        region = handle.region()
        while True:
            image = handle.frame()
            if image is None:
                break
            images.append(image)
            handle.report(mod.Rectangle(region.x + len(images), region.y, region.width, region.height))
        handle.quit()
        lines = fout.getvalue().splitlines()
        # the hello names the tracker: the rest of the session is the protocol's
        outs.append((images, tuple(region), lines[1:]))
        assert parse_message(lines[0])[0] == "hello"
    assert outs[0] == outs[1]
    assert outs[0][0] == ["/a/0.jpg", "/a/1.jpg", "/a/2.jpg"]


def test_trax_quit_after_hello_is_a_clean_exit():
    with pytest.raises(SystemExit) as e:
        tvot.VOT("rectangle", mode="trax", trax_streams=(io.StringIO("@@TRAX:quit\n"), io.StringIO()))
    assert e.value.code == 0


def _tracker_regions(paths):
    """The in-process StreamingTracker the track-vot command builds from
    the same flags, over the same frames."""
    from ntm_tracker_tpu_torch.models.core import make_core
    from ntm_tracker_tpu_torch.tracking.tracker import StreamingTracker

    args = cli.build_parser().parse_args(["--device", "cpu", "track-vot", *MODEL])
    cfg = cli._tracker_config(args, "ntm")
    core = make_core(cfg)
    trk = StreamingTracker(cfg, cli._load_vgg(args, "cpu"), cli._resolve_tracker_weights(args, cfg, core, "cpu"),
                           core, device="cpu")
    trk.init(np.array(Image.open(paths[0]).convert("RGB")), REGION0)
    return [trk.track(np.array(Image.open(p).convert("RGB"))) for p in paths[1:]]


def test_track_vot_trax_session_over_pipes(tmp_path):
    paths = [str(tmp_path / n) for n in _frames(str(tmp_path))]
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.Popen(
        [sys.executable, "-m", "ntm_tracker_tpu_torch", "--device", "cpu", "track-vot", "--vot_mode", "trax",
         *MODEL], cwd=str(tmp_path), env=env, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        lines = [proc.stdout.readline()]
        assert parse_message(lines[0])[0] == "hello", lines
        proc.stdin.write(format_message("initialize", ["file://" + paths[0], ",".join(map(str, REGION0))]) + "\n")
        proc.stdin.flush()
        lines.append(proc.stdout.readline())
        states = []
        for p in paths[1:]:
            proc.stdin.write(format_message("frame", [p]) + "\n")
            proc.stdin.flush()
            lines.append(proc.stdout.readline())
            states.append(parse_message(lines[-1]))
        proc.stdin.write(format_message("quit", []) + "\n")
        proc.stdin.close()
        rest, err = proc.stdout.read(), proc.stderr.read()
        assert proc.wait(timeout=120) == 0, err
    finally:
        if proc.poll() is None:
            proc.kill()
    lines += rest.splitlines(keepends=True)
    # nothing but protocol lines on stdout; the chatter went to stderr
    assert all(parse_message(line) is not None for line in lines), lines
    assert [parse_message(line)[0] for line in lines] == ["hello", "state"] + ["state"] * 3 + ["quit"]
    # the session's own launch counts: none on the CPU, where the wrappers
    # run their plain versions
    assert "tracked 4 frames (launches: ntm_scan_fused 0, fused_ntm_addressing 0)" in err
    assert [s[0] for s in states] == ["state"] * 3
    got = np.array([[float(v) for v in s[1][0].split(",")] for s in states])
    np.testing.assert_allclose(got, np.array(_tracker_regions(paths)), rtol=0, atol=1e-9)


def test_kernel_build_log_goes_to_stderr(tmp_path, monkeypatch, capfd):
    """_build's compile report must stay off stdout, which is the TraX wire
    when track-vot builds a kernel at its first frame on the card. A stand-in
    compiler writes the library and a ptxas-like report."""
    from ntm_tracker_tpu_torch import _build

    fake = tmp_path / "fake_nvcc"
    fake.write_text('#!/bin/sh\nwhile [ "$1" != "-o" ]; do shift; done\ntouch "$2"\n'
                    'echo "ptxas info    : Used 32 registers" >&2\n')
    fake.chmod(0o755)
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path / "build")
    monkeypatch.setattr(_build, "_nvcc", lambda: str(fake))
    out = _build.build_all(["addressing"])
    assert out["addressing"].exists()
    captured = capfd.readouterr()
    assert captured.out == ""
    assert "[build] addressing" in captured.err and "Used 32 registers" in captured.err
