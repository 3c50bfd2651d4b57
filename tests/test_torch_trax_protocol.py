"""tracking/trax_protocol.py of the port against the JAX package's: the
wire format (format_message, parse_message, strip_image_uri) on the same
tokens, line for line, the newline rejection, and a scripted session
through TraxServer over in-memory streams, message for message."""

import io

import pytest

from ntm_tracker_tpu.tracking import trax_protocol as jtp
from ntm_tracker_tpu_torch.tracking import trax_protocol as ttp

MESSAGES = [
    ("frame", ["img0.jpg"], None),
    ("initialize", ['/data/my seq/weird "name"\\img.jpg', "1.5,2,3,4"], {"trax.name": "a b"}),
    ("initialize", ["seq=3/img.jpg", "1,2,3,4"], None),
    ("state", ["10.0,20.5,30,40"], {"trax.time": "0.01"}),
    ("hello", [], {"trax.version": "3", "trax.region": "rectangle"}),
    ("frame", ["file:///tmp/a b.jpg"], {}),
    ("quit", [], None),
    ("frame", [""], None),
    ("frame", ["tab\there"], None),
]

LINES = [
    "@@TRAX:frame img0.jpg\n",
    '@@TRAX:initialize "a.jpg" "10,10,5,5" trax.ignore=1\n',
    '@@TRAX:frame "img=0.jpg"\n',
    '@@TRAX:frame key="a b"\r\n',
    "@@TRAX:FRAME x.jpg",
    "some stray logging\n",
    "",
    "@@TRAX:",
    '@@TRAX:initialize "unterminated \\"quote',
]


@pytest.mark.parametrize("mtype,args,props", MESSAGES)
def test_format_and_parse_match_jax(mtype, args, props):
    line = ttp.format_message(mtype, args, props)
    assert line == jtp.format_message(mtype, args, props)
    assert ttp.parse_message(line) == jtp.parse_message(line)
    assert ttp.parse_message(line)[:2] == (mtype, args)


@pytest.mark.parametrize("line", LINES)
def test_parse_lines_match_jax(line):
    assert ttp.parse_message(line) == jtp.parse_message(line)


@pytest.mark.parametrize("image", ["file:///tmp/x.jpg", "/tmp/x.jpg", "relative/x.jpg", "file://"])
def test_strip_image_uri_matches_jax(image):
    assert ttp.strip_image_uri(image) == jtp.strip_image_uri(image)


@pytest.mark.parametrize("bad", ["a\nb", "a\rb"])
def test_newlines_rejected(bad):
    for mod in (ttp, jtp):
        with pytest.raises(ValueError, match="newlines"):
            mod.format_message("frame", [bad])


def _session(mod, client_lines):
    """Run a server of `mod` over a scripted client; return (requests,
    server output lines)."""
    fin, fout = io.StringIO("".join(client_lines)), io.StringIO()
    server = mod.TraxServer("rectangle", fin, fout, name="tracker")
    requests = []
    while True:
        req = server.wait()
        requests.append((req.type, req.image, req.region, req.properties))
        if req.type == "quit":
            break
        server.status("1.0,2.0,3.0,4.0", {"trax.confidence": "0.5"})
    server.quit()
    server.quit()  # idempotent
    return requests, fout.getvalue().splitlines()


def test_session_matches_jax_message_for_message():
    client = [
        "stray line the spec says to ignore\n",
        '@@TRAX:initialize "file:///data/seq 1/0001.jpg" "10,20,30,40" trax.x=1\n',
        "@@TRAX:frame file:///data/seq%201/0002.jpg\n",
        '@@TRAX:frame "/data/seq 1/0003.jpg"\n',
        "@@TRAX:quit\n",
    ]
    got, want = _session(ttp, client), _session(jtp, client)
    assert got == want
    requests, lines = got
    assert [r[0] for r in requests] == ["initialize", "frame", "frame", "quit"]
    assert requests[0][1:3] == ("/data/seq 1/0001.jpg", "10,20,30,40")
    assert all(ttp.parse_message(line) is not None for line in lines)
    assert lines[0].startswith("@@TRAX:hello") and lines[-1] == "@@TRAX:quit"


def test_eof_is_quit_and_malformed_raises():
    requests, _ = _session(ttp, [])
    assert requests == [("quit", None, None, {})]
    for mod in (ttp, jtp):
        server = mod.TraxServer("rectangle", io.StringIO("@@TRAX:initialize only_one\n"), io.StringIO())
        with pytest.raises(ValueError, match="malformed initialize"):
            server.wait()
        server = mod.TraxServer("rectangle", io.StringIO("@@TRAX:bogus x\n"), io.StringIO())
        with pytest.raises(ValueError, match="unexpected client message"):
            server.wait()
