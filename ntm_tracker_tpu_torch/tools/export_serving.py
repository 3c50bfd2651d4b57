"""Exported serving artifact: the whole-frame tracking step as
torch.export programs with the weights inside (counterpart of
ntm_tracker_tpu/tools/export_serving.py).

A serving process needs neither the model code nor the weights' files:
`torch.export.export` records the port's frame step
(tracking/tracker.py:make_frame_fn, the function build_frame_step binds)
as a program whose buffers are the weights, and `torch.export.save`
serializes it. The artifact holds the streaming tracker's three serving
entry points:

  init   ()                          -> state leaves [B,...]  (learnable)
  first  (crops [1,S,S,3], gt [1,F], leaves at B=1) -> (offsets [1,2], leaves)
  step   (crops [B,S,S,3], leaves)   -> (offsets [B,2], leaves)

plus, with `device_loop=(H, W)` (CLI `--device_loop HxW`), the
device-resident loop of tracking/tracker.py:make_device_track_step (crop
geometry, VGG, the cell steps and the recrop in one program, for raw RGB
frames of a fixed HxW already on the device):

  dinit  (frames [B,H,W,3], bbox0 [B,4], leaves) -> leaves
  dstep  (frames [B,H,W,3], bbox [B,4], leaves)
         -> (region [B,4] x,y,w,h px, next_bbox [B,4], leaves)

first is always batch 1: presenting a first frame is a per-track event
(StreamingTracker serves B=1; FleetTracker.add presents one track and
writes its state into the batch), while init/step carry the artifact's
batch (--batch N: FleetTracker.from_serving). State crosses the boundary
as flat leaves, in the JAX package's tree order (a dict's keys sorted,
lists and NamedTuples in order), so the two packages' artifacts line up
leaf for leaf.

The entry points share programs, since each export costs seconds: the
frame step is one program with the target indicator as an input and the
batch dimension left free (`frame`: first runs it at B=1 with the
indicator, step at the artifact's batch with zeros), and the device loop's
program takes an indicator too (`device`: dinit passes the canonical
first-frame indicator and keeps the state, dstep passes zeros). A step is
the frame step with a zero indicator in the live code too
(serialize_streaming_batch), so the numbers are the same.

The container is the JAX artifact's: one .npz with a `meta` JSON and each
program's bytes, here one program per platform (`<entry>.<platform>`,
platforms "cuda" and/or "cpu"; a cuda program runs only on cuda tensors,
so ServingModel loads the programs of its device and raises if the
artifact has none). The format string is the port's own: ServingModel
refuses a JAX artifact (StableHLO programs) by it.

The artifact runs the plain cell route, as the JAX artifact does, and says
so in meta["route"]: _portable pins fused_inference=False and
use_pallas=False and the core is rebuilt from that config. The live
trackers keep B1 and B3. The rebuilt core runs its steps as one scan
(models/traced_loop.scan_steps), so a program records one cell step, not
65.

Usage:
  python -m ntm_tracker_tpu_torch export-serving --out serving.npz \\
      [model flags] [--batch 1] [--platforms cuda,cpu] [--device_loop 360x640]
"""

from __future__ import annotations

import dataclasses
import io
import json
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.utils._pytree as pytree

_FORMAT = "ntm-tracker-serving-torch-v1"
# the JAX package's artifact (StableHLO programs): refused by name
_JAX_FORMAT = "ntm-tracker-serving-v1"
PLATFORMS = ("cuda", "cpu")
ROUTE = ("plain cell loop (fused_inference=False, use_pallas=False), the steps as one torch scan; "
         "no hand-written kernel in the programs")


# -- state leaves in the JAX package's tree order ----------------------------

def state_leaves(tree) -> List[torch.Tensor]:
    """The state's tensors in jax.tree_util order: a dict's entries by
    sorted key, lists, tuples and NamedTuples in order."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in state_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in state_leaves(v)]
    return [tree]


def state_from_leaves(template, leaves):
    """Rebuild a state shaped like `template` from state_leaves' order."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            filled = {k: build(node[k]) for k in sorted(node)}
            return {k: filled[k] for k in node}
        if isinstance(node, (list, tuple)):
            children = [build(v) for v in node]
            return type(node)(*children) if hasattr(node, "_fields") else type(node)(children)
        return next(it)

    out = build(template)
    if next(it, None) is not None:
        raise ValueError("more state leaves than the template holds")
    return out


class _Program(torch.nn.Module):
    """fn(weights, *args) as a module whose buffers are the weights, so the
    exported program carries them (and the traced scan sees them as
    inputs, not closed-over constants)."""

    def __init__(self, fn, weights):
        super().__init__()
        self._fn = fn
        leaves, self._spec = pytree.tree_flatten(weights)
        for i, leaf in enumerate(leaves):
            self.register_buffer(f"w{i}", leaf.detach().contiguous())
        self._n = len(leaves)

    def forward(self, *args):
        weights = pytree.tree_unflatten([getattr(self, f"w{i}") for i in range(self._n)], self._spec)
        return self._fn(weights, *args)


def _export(fn, weights, args, dynamic_batch: bool = False) -> bytes:
    """fn(weights, *args) as a saved torch.export program; dynamic_batch
    lets every input's first dimension vary (one program for any batch)."""
    dynamic = None
    if dynamic_batch:
        batch = torch.export.Dim("batch", min=1, max=1 << 16)
        dynamic = (tuple({0: batch} for _ in args),)
    with torch.no_grad():
        program = torch.export.export(_Program(fn, weights), tuple(args), dynamic_shapes=dynamic)
    buf = io.BytesIO()
    torch.export.save(program, buf)
    return buf.getvalue()


def _portable(cfg):
    """Exported programs run the plain cell route: pin the fused frame
    kernel (fused_inference) and the per-step addressing kernel (use_pallas)
    off. The kernels' wrappers are ctypes calls, which torch.export cannot
    record."""
    if cfg.fused_inference is False and not cfg.ntm.use_pallas:
        return cfg
    return dataclasses.replace(cfg, fused_inference=False, ntm=dataclasses.replace(cfg.ntm, use_pallas=False))


def export_serving(
    cfg,
    core,
    vgg_params: Any,
    params: Any,
    batch: int = 1,
    delimiter_first: bool = False,
    platforms: Optional[Sequence[str]] = None,
    device_loop: Optional[Tuple[int, int]] = None,
) -> dict:
    """Export init/first/step (and dinit/dstep at device_loop=(H, W)) for
    each platform; returns the artifact dict (np.savez-able). platforms
    defaults to ["cuda"] (the port's device); "cpu" traces on the CPU.
    `core` (the JAX signature's) is not read: the exported core is rebuilt
    from the portable config."""
    from ntm_tracker_tpu_torch.config import resolve_device
    from ntm_tracker_tpu_torch.models.core import make_core
    from ntm_tracker_tpu_torch.models.traced_loop import scan_steps
    from ntm_tracker_tpu_torch.tracking.tracker import _to_device, make_device_track_fns, make_frame_fn

    platforms = list(platforms or ["cuda"])
    for p in platforms:
        if p not in PLATFORMS:
            raise ValueError(f"unknown export platform {p!r}: the port exports for {', '.join(PLATFORMS)} "
                             "(a TPU program comes from the JAX package's export-serving)")
    if device_loop is not None:
        H, W = int(device_loop[0]), int(device_loop[1])
        if H < 2 or W < 2:
            raise ValueError(f"device_loop frame geometry too small: {H}x{W}")
    # the core captured its cfg at make_core time: rebuild it from the
    # portable config, so the pinned route applies, with its steps as one
    # scan (the params are the same tree)
    cfg = _portable(cfg)
    core = make_core(cfg, loop=scan_steps)
    S, F = cfg.data.crop_size, cfg.num_features
    artifact = {}
    leaf_meta = None
    for p in platforms:
        dev = resolve_device(p)
        # conv5 serves only the pool5 endpoint: the token path stops at conv4_3
        weights = {"vgg": _to_device({k: v for k, v in vgg_params.items() if not k.startswith("conv5")}, dev),
                   "core": _to_device(params, dev)}
        with torch.no_grad():
            state_b = core.init_state(weights["core"], batch)
            state_2 = core.init_state(weights["core"], 2)
        leaves_b = state_leaves(state_b)
        leaf_meta = [{"shape": list(l.shape), "dtype": str(l.dtype).replace("torch.", "")} for l in leaves_b]
        frame_fn = make_frame_fn(cfg, core, delimiter_first, dev)

        def flat_init(w):
            return tuple(state_leaves(core.init_state(w["core"], batch)))

        def flat_frame(w, crops, gt, *leaves):
            offsets, new = frame_fn(w["vgg"], w["core"], crops, gt, state_from_leaves(state_2, leaves))
            return (offsets, *state_leaves(new))

        artifact[f"init.{p}"] = _export(flat_init, {"core": weights["core"]}, ())
        # one program for every batch: traced at 2 rows (an example of 1
        # would specialize the batch dimension), run at 1 (first) or more
        frame_args = (torch.zeros(2, S, S, 3, device=dev), torch.zeros(2, F, device=dev), *state_leaves(state_2))
        artifact[f"frame.{p}"] = _export(flat_frame, weights, frame_args, dynamic_batch=True)
        if device_loop is not None:
            _, step_body = make_device_track_fns(cfg, frame_fn, dev)

            def flat_device(w, frames, bbox, gt, *leaves):
                region, nbbox, new = step_body(w["vgg"], w["core"], frames, bbox, state_from_leaves(state_b, leaves),
                                               gt=gt)
                return (region, nbbox, *state_leaves(new))

            artifact[f"device.{p}"] = _export(flat_device, weights, (
                torch.zeros(batch, H, W, 3, device=dev), torch.tensor([[0.25, 0.25, 0.75, 0.75]] * batch, device=dev),
                torch.zeros(batch, F, device=dev), *leaves_b))

    meta = {
        "format": _FORMAT,
        "batch": batch,
        "first_batch": 1,  # first is a per-track event (FleetTracker.add)
        "crop_size": S,
        "num_features": F,
        "core": cfg.core,
        "data": dataclasses.asdict(cfg.data),  # host recrop geometry
        "feature_points": None if cfg.feature_points is None else [list(p) for p in cfg.feature_points],
        "delimiter_first": delimiter_first,
        # the host decode branches on these (tracker.decode_head)
        "predict_scale": bool(cfg.predict_scale),
        "scale_range": float(cfg.scale_range),
        # provenance: the token path (exact or int8) is in the programs
        "vgg_int8": bool(cfg.vgg_int8),
        "platforms": platforms,
        "route": ROUTE,
        "device_loop": None if device_loop is None else [H, W],
        "state_leaves": leaf_meta,
        "torch_version": torch.__version__,
    }
    out = {"meta": np.asarray(json.dumps(meta))}
    out.update({k: np.frombuffer(v, np.uint8) for k, v in artifact.items()})
    return out


def save_serving(path: str, artifact: dict) -> None:
    np.savez(path, **artifact)


def config_from_meta(meta: dict):
    """The host-geometry TrackerConfig of an artifact's meta, for every
    from_serving constructor (StreamingTracker, FleetTracker). Weights and
    programs stay in the artifact; this config only drives the host-side
    crop and recrop geometry and the decode."""
    from ntm_tracker_tpu_torch.config import DataConfig, TrackerConfig

    data = dict(meta["data"])
    data["resize_hw"] = tuple(data["resize_hw"])  # JSON round trip
    fp = meta.get("feature_points")
    if fp is not None and len(fp) != meta["num_features"]:
        raise ValueError(f"corrupt artifact meta: {len(fp)} feature_points vs num_features={meta['num_features']}")
    return TrackerConfig(
        core=meta["core"], data=DataConfig(**data), num_features=meta["num_features"],
        feature_points=None if fp is None else tuple(tuple(p) for p in fp),
        predict_scale=bool(meta.get("predict_scale", False)),
        scale_range=float(meta.get("scale_range", 0.15)),
        vgg_int8=bool(meta.get("vgg_int8", False)),
    )


class ServingModel:
    """Load an exported artifact and serve it on `device` (cuda unless the
    caller names another): no model code, no weights' files.

    first/step return (offsets [B, head_dim] tensor, state leaves tuple),
    all on the device."""

    def __init__(self, path: str, device=None):
        from ntm_tracker_tpu_torch.config import resolve_device

        self.device = resolve_device(device)
        platform = self.device.type
        with np.load(path) as z:
            self.meta = json.loads(str(z["meta"]))
            fmt = self.meta.get("format")
            if fmt == _JAX_FORMAT:
                raise ValueError(
                    f"{path} is the JAX package's serving artifact (StableHLO programs, format {fmt!r}); the port "
                    "serves its own: re-export with python -m ntm_tracker_tpu_torch export-serving")
            if fmt != _FORMAT:
                raise ValueError(f"not a serving artifact of the port: {path} (format {fmt!r})")
            if f"frame.{platform}" not in z:
                raise ValueError(f"{path} has no program for {platform} (it holds {self.meta['platforms']}); "
                                 f"re-export with export-serving --platforms {platform}")
            programs = {name: torch.export.load(io.BytesIO(z[f"{name}.{platform}"].tobytes())).module()
                        for name in ("init", "frame", "device") if f"{name}.{platform}" in z}
        self._init, self._frame = programs["init"], programs["frame"]
        self._device = programs.get("device")
        B, F = self.meta["batch"], self.meta["num_features"]
        self._zero_gt = torch.zeros(B, F, device=self.device)
        if self._device is not None:
            from ntm_tracker_tpu_torch.tracking.tracker import canonical_first_frame_gt

            heat0 = torch.as_tensor(canonical_first_frame_gt(config_from_meta(self.meta)), device=self.device)
            self._heat0 = heat0[None].expand(B, -1).contiguous()

    def _f32(self, x) -> torch.Tensor:
        # device tensors stay on the device; numpy is uploaded once
        return torch.as_tensor(x, dtype=torch.float32, device=self.device)

    @torch.no_grad()
    def init_state(self) -> Tuple:
        return tuple(self._init())

    @torch.no_grad()
    def first(self, crops, gt, leaves) -> Tuple[torch.Tensor, Tuple]:
        out = self._frame(self._f32(crops), self._f32(gt), *leaves)
        return out[0], tuple(out[1:])

    @torch.no_grad()
    def step(self, crops, leaves) -> Tuple[torch.Tensor, Tuple]:
        out = self._frame(self._f32(crops), self._zero_gt, *leaves)
        return out[0], tuple(out[1:])

    # -- device-resident loop (export-serving --device_loop HxW) ----------
    @property
    def has_device_loop(self) -> bool:
        return self._device is not None

    def _need_device_loop(self):
        if self._device is None:
            raise ValueError("artifact has no device-resident loop; re-export with export-serving --device_loop HxW")

    @torch.no_grad()
    def device_init(self, frames, bbox0, leaves) -> Tuple:
        """frames [B,H,W,3] raw RGB at the baked geometry, bbox0 [B,4]
        y1x1y2x2 in the tracker's /(dim-1) normalization -> state leaves."""
        self._need_device_loop()
        return tuple(self._device(self._f32(frames), self._f32(bbox0), self._heat0, *leaves)[2:])

    @torch.no_grad()
    def device_step(self, frames, bbox, leaves):
        """-> (region [B,4] x,y,w,h px, next_bbox [B,4], state leaves), all
        on the device: next_bbox feeds the next device_step."""
        self._need_device_loop()
        out = self._device(self._f32(frames), self._f32(bbox), self._zero_gt, *leaves)
        return out[0], out[1], tuple(out[2:])
