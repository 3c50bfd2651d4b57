"""Native TraX wire-protocol server, no `trax` package required
(counterpart of ntm_tracker_tpu/tracking/trax_protocol.py, the same wire
format).

The reference's VOT integration (vot.py:103-162) can only speak to the VOT
toolkit through the optional `trax` python bindings; when they are absent it
falls back to the images.txt/region.txt file protocol. This module
implements the tracker side of the TraX protocol itself (the line-oriented
`@@TRAX:` handshake the toolkit speaks over the tracker's stdin/stdout), so
trax-server mode works out of the box.

Protocol shape (TraX specification, votchallenge/trax):

  server -> client   @@TRAX:hello trax.version=3 trax.name=... \
                         trax.region=rectangle trax.image=path \
                         trax.channels=color
  client -> server   @@TRAX:initialize "<image>" "<region>"
  server -> client   @@TRAX:state "<region>"
  client -> server   @@TRAX:frame "<image>"
  server -> client   @@TRAX:state "<region>"
  client -> server   @@TRAX:quit

Arguments are space-separated; arguments containing spaces are quoted with
double quotes, with backslash escaping inside. Trailing `key=value` tokens
are named properties. Images in `path` format arrive either as a bare
filesystem path or as a `file://` URI; regions are comma-separated floats
(`x,y,w,h` rectangle, `x1,y1,x2,y2,...` polygon).

IMPORTANT for integrators: in trax mode the tracker's STDOUT belongs to the
protocol — anything else printed there corrupts the channel. The CLI's
track-vot routes its informational prints to stderr for this reason.
"""

from __future__ import annotations

import dataclasses
import sys
from typing import Dict, List, Optional, TextIO, Tuple

PREFIX = "@@TRAX:"


def _quote(token: str) -> str:
    """Serialize one argument; quote whenever it is not a plain word.
    '=' forces quoting so a positional argument containing it (a legal
    filename) cannot round-trip into a key=value property. Newlines are
    REJECTED: the protocol is line-framed (the peer reads with readline)
    and its escape syntax covers only backslash/quote, so a '\\n' inside a
    token would silently split one message across two physical lines."""
    if "\n" in token or "\r" in token:
        raise ValueError(
            f"TraX tokens cannot contain newlines (line-framed protocol): "
            f"{token!r}"
        )
    if token and all(c not in ' "\\\t=' for c in token):
        return token
    return '"' + token.replace("\\", "\\\\").replace('"', '\\"') + '"'


def _tokenize(body: str) -> List[Tuple[str, bool]]:
    """Split a message body into (token, starts_quoted) pairs, honoring
    quotes and escapes. Whether a token STARTS with a quote must survive
    tokenization: a token opening with '\"' is always a positional argument,
    never a key=value property — otherwise a legal filename containing '='
    would be misparsed as a property. (A property with a quoted VALUE,
    key=\"a b\", starts unquoted and stays a property.)"""
    tokens: List[Tuple[str, bool]] = []
    cur: List[str] = []
    in_quotes = False
    escaped = False
    started = False
    starts_quoted = False
    for c in body:
        if escaped:
            cur.append(c)
            escaped = False
        elif c == "\\":
            escaped = True
            started = True
        elif c == '"':
            in_quotes = not in_quotes
            if not started:
                starts_quoted = True
            started = True
        elif c in " \t" and not in_quotes:
            if started:
                tokens.append(("".join(cur), starts_quoted))
                cur, started, starts_quoted = [], False, False
        else:
            cur.append(c)
            started = True
    if started:
        tokens.append(("".join(cur), starts_quoted))
    return tokens


def format_message(mtype: str, args: List[str],
                   properties: Optional[Dict[str, str]] = None) -> str:
    parts = [PREFIX + mtype]
    parts += [_quote(a) for a in args]
    for k, v in (properties or {}).items():
        parts.append(f"{k}={_quote(v)}")
    return " ".join(parts)


def parse_message(line: str) -> Optional[Tuple[str, List[str], Dict[str, str]]]:
    """Parse one protocol line -> (type, positional args, properties);
    None for lines that are not TraX messages (the spec says to ignore
    them)."""
    line = line.rstrip("\r\n")
    if not line.startswith(PREFIX):
        return None
    tokens = _tokenize(line[len(PREFIX):])
    if not tokens:
        return None
    mtype, rest = tokens[0][0].lower(), tokens[1:]
    args: List[str] = []
    props: Dict[str, str] = {}
    for tok, starts_quoted in rest:
        key, eq, value = tok.partition("=")
        if (not starts_quoted and eq and key
                and all(c.isalnum() or c in "._" for c in key)):
            props[key] = value
        else:
            args.append(tok)
    return mtype, args, props


def strip_image_uri(image: str) -> str:
    """Path-format images may arrive as file:// URIs."""
    if image.startswith("file://"):
        return image[len("file://"):]
    return image


@dataclasses.dataclass
class TraxRequest:
    type: str                      # "initialize" | "frame" | "quit"
    image: Optional[str] = None    # filesystem path (URI stripped)
    region: Optional[str] = None   # raw comma-separated region string
    properties: Dict[str, str] = dataclasses.field(default_factory=dict)


class TraxServer:
    """The tracker side of a TraX session over a line stream pair.

    Mirrors the surface of trax.server.Server that the reference's vot.py
    touches (wait/status/quit), so the VOT handle can drive either.
    """

    def __init__(self, region_format: str, fin: Optional[TextIO] = None,
                 fout: Optional[TextIO] = None,
                 name: str = "ntm_tracker_tpu_torch"):
        assert region_format in ("rectangle", "polygon")
        self._fin = fin if fin is not None else sys.stdin
        self._fout = fout if fout is not None else sys.stdout
        self._region_format = region_format
        self._closed = False
        self._send("hello", [], {
            "trax.version": "3",
            "trax.name": name,
            "trax.region": region_format,
            "trax.image": "path",
            "trax.channels": "color",
        })

    def _send(self, mtype: str, args: List[str],
              props: Optional[Dict[str, str]] = None) -> None:
        self._fout.write(format_message(mtype, args, props) + "\n")
        self._fout.flush()

    def wait(self) -> TraxRequest:
        """Block until the next initialize/frame/quit request (EOF counts
        as quit; non-protocol lines are ignored per the spec)."""
        while True:
            line = self._fin.readline()
            if not line:  # client hung up
                return TraxRequest("quit")
            parsed = parse_message(line)
            if parsed is None:
                continue
            mtype, args, props = parsed
            if mtype == "initialize":
                if len(args) < 2:
                    raise ValueError(f"malformed initialize: {line!r}")
                return TraxRequest("initialize", strip_image_uri(args[0]),
                                   args[1], props)
            if mtype == "frame":
                if len(args) < 1:
                    raise ValueError(f"malformed frame: {line!r}")
                return TraxRequest("frame", strip_image_uri(args[0]),
                                   None, props)
            if mtype == "quit":
                return TraxRequest("quit", properties=props)
            raise ValueError(f"unexpected client message {mtype!r}")

    def status(self, region_string: str,
               props: Optional[Dict[str, str]] = None) -> None:
        """Report the tracker state for the current frame."""
        self._send("state", [region_string], props)

    def quit(self) -> None:
        if not self._closed:
            self._closed = True
            try:
                self._send("quit", [])
            except (ValueError, OSError):
                # stream closed (interpreter teardown) or the client hung
                # up without reading the reply (BrokenPipeError) — a clean
                # session must not turn into a tracker failure
                pass
