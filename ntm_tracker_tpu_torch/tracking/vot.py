"""VOT challenge protocol adapter (file mode, native TraX, trax package;
counterpart of ntm_tracker_tpu/tracking/vot.py).

Python-3 re-expression of the reference vot.py: region parse/encode
(:27-41), rectangle/polygon conversion (:43-80), and the VOT handle (:82-173)
that either speaks the TraX protocol or falls back to the
images.txt / region.txt / output.txt file protocol.

Beyond the reference: TraX server mode no longer requires the optional
`trax` package — `mode="trax"` speaks the wire protocol natively over
stdin/stdout (tracking/trax_protocol.py), so the VOT toolkit can drive this
tracker with zero extra dependencies. The trax-package branch is kept for
parity with the reference (`mode="trax-lib"`, auto-selected when the
package is importable).
"""

from __future__ import annotations

import collections
import copy
import os
from typing import List, Optional, Union

try:  # pragma: no cover - optional dependency
    import trax
    import trax.server

    TRAX = True
except ImportError:
    TRAX = False

Rectangle = collections.namedtuple("Rectangle", ["x", "y", "width", "height"])
Point = collections.namedtuple("Point", ["x", "y"])
Polygon = collections.namedtuple("Polygon", ["points"])

Region = Union[Rectangle, Polygon]


def parse_region(string: str) -> Optional[Region]:
    tokens = [float(t) for t in string.split(",")]
    if len(tokens) == 4:
        return Rectangle(*tokens)
    if len(tokens) % 2 == 0 and len(tokens) > 4:
        return Polygon([Point(tokens[i], tokens[i + 1]) for i in range(0, len(tokens), 2)])
    return None


def encode_region(region: Region) -> str:
    if isinstance(region, Polygon):
        return ",".join("{},{}".format(p.x, p.y) for p in region.points)
    if isinstance(region, Rectangle):
        return "{},{},{},{}".format(region.x, region.y, region.width, region.height)
    return ""


def convert_region(region: Region, to: str) -> Optional[Region]:
    if to == "rectangle":
        if isinstance(region, Rectangle):
            return copy.copy(region)
        if isinstance(region, Polygon):
            top = min(p.y for p in region.points)
            bottom = max(p.y for p in region.points)
            left = min(p.x for p in region.points)
            right = max(p.x for p in region.points)
            return Rectangle(left, top, right - left, bottom - top)
        return None
    if to == "polygon":
        if isinstance(region, Rectangle):
            return Polygon(
                [
                    Point(region.x, region.y),
                    Point(region.x + region.width, region.y),
                    Point(region.x + region.width, region.y + region.height),
                    Point(region.x, region.y + region.height),
                ]
            )
        if isinstance(region, Polygon):
            return copy.copy(region)
        return None
    return None


class VOT:
    """VOT integration handle (reference vot.py:82-173).

    mode:
      "auto"     — trax-lib when the `trax` package is importable (the
                   reference's detection rule), else file mode
      "trax"     — native TraX wire protocol over stdin/stdout (or the
                   injected `trax_streams=(fin, fout)`), no dependencies
      "trax-lib" — the optional `trax` package (reference branch)
      "file"     — images.txt / region.txt / output.txt in `workdir`
    """

    def __init__(self, region_format: str, workdir: str = ".",
                 mode: str = "auto", trax_streams=None):
        assert region_format in ("rectangle", "polygon")
        assert mode in ("auto", "trax", "trax-lib", "file")
        self._workdir = workdir
        if mode == "auto":
            mode = "trax-lib" if TRAX else "file"
        if mode == "trax-lib" and not TRAX:
            raise RuntimeError("mode='trax-lib' needs the trax package; "
                               "use mode='trax' for the native protocol")
        if mode == "trax":
            from ntm_tracker_tpu_torch.tracking.trax_protocol import TraxServer

            fin, fout = trax_streams or (None, None)
            self._trax_native = TraxServer(region_format, fin, fout)
            request = self._trax_native.wait()
            if request.type == "quit":
                # the toolkit probes trackers (or aborts a run) by closing
                # stdin / quitting right after the hello: a clean no-op
                # session, not a tracker failure
                self._trax_native.quit()
                raise SystemExit(0)
            if request.type != "initialize":
                raise RuntimeError(
                    f"expected initialize, got {request.type!r}")
            self._region = convert_region(
                parse_region(request.region), region_format)
            self._image = request.image
            self._trax_native.status(encode_region(self._region))
        elif mode == "trax-lib":  # pragma: no cover - requires trax server
            options = trax.server.ServerOptions(region_format, trax.image.PATH)
            self._trax = trax.server.Server(options)
            request = self._trax.wait()
            assert request.type == "initialize"
            if request.region.type == "polygon":
                self._region = Polygon([Point(x[0], x[1]) for x in request.region.points])
            else:
                r = request.region
                self._region = Rectangle(r.x, r.y, r.width, r.height)
            self._image = str(request.image)
            self._trax.status(request.region)
        else:
            with open(os.path.join(workdir, "images.txt")) as f:
                self._files = [x.strip("\n") for x in f.readlines()]
            self._frame = 0
            with open(os.path.join(workdir, "region.txt")) as f:
                self._region = convert_region(parse_region(f.readline()), region_format)
            self._result: List[Region] = []

    def region(self) -> Region:
        return self._region

    def report(self, region: Region) -> None:
        if hasattr(self, "_trax_native"):
            self._trax_native.status(encode_region(region))
        elif hasattr(self, "_trax"):  # pragma: no cover
            if isinstance(region, Polygon):
                tregion = trax.region.Polygon([(p.x, p.y) for p in region.points])
            else:
                tregion = trax.region.Rectangle(
                    region.x, region.y, region.width, region.height
                )
            self._trax.status(tregion)
        else:
            self._result.append(region)
            self._frame += 1

    def frame(self) -> Optional[str]:
        if hasattr(self, "_trax_native"):
            if getattr(self, "_image", None) is not None:
                image = self._image
                self._image = None
                return image
            request = self._trax_native.wait()
            if request.type == "frame":
                return request.image
            return None
        if hasattr(self, "_trax"):  # pragma: no cover
            if hasattr(self, "_image"):
                image = self._image
                del self._image
                return image
            request = self._trax.wait()
            if request.type == "frame":
                return str(request.image)
            return None
        if self._frame >= len(self._files):
            return None
        path = self._files[self._frame]
        # images.txt entries are commonly relative to the sequence dir (the
        # reference runs from that dir; the workdir generalization must
        # resolve them against workdir, not the process CWD)
        if not os.path.isabs(path):
            path = os.path.join(self._workdir, path)
        return path

    def quit(self) -> None:
        if hasattr(self, "_trax_native"):
            self._trax_native.quit()
        elif hasattr(self, "_trax"):  # pragma: no cover
            self._trax.quit()
        elif hasattr(self, "_result"):
            with open(os.path.join(self._workdir, "output.txt"), "w") as f:
                for r in self._result:
                    f.write(encode_region(r) + "\n")

    def __del__(self):
        self.quit()
