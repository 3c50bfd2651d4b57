"""Fleet tracking: many simultaneous tracks in one batched frame step
(counterpart of ntm_tracker_tpu/tracking/fleet.py:48-257).

N independent tracks share one frame step (crops [N,224,224,3] ->
offsets [N, head_dim] and the batched state), so the card amortizes the
VGG and NTM work over the fleet. The crop/decode geometry stays per track
on the host (numpy), as in StreamingTracker; the crops are cut on the
device from the uploaded frames (crop_and_resize_mm).

Tracks are slots: `add(image, region)` claims one and presents its
target-indicated first frame, `step(images)` advances every active track
one frame, `remove(slot)` frees one (its state goes back to the learnable
initial state). The batch width is fixed at construction; inactive slots
get zero crops, and their outputs are ignored.

Slot writes are out of place (index_copy), so no write reaches a tensor
that an earlier state or another slot shares. FleetTracker.from_serving
drives the fleet from an exported artifact (tools/export_serving.py,
--batch equal to the capacity). FleetTracker(mesh=) splits the slots over
a parallel.mesh.Mesh's local devices: slots [i*n, (i+1)*n) are shard i, a
fleet of its own on device i (the JAX package lets GSPMD split one
batched step; here each device runs its shard's step).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ntm_tracker_tpu_torch.config import TrackerConfig, resolve_device
from ntm_tracker_tpu_torch.data import geometry
from ntm_tracker_tpu_torch.data.image_ops import crop_and_resize_mm
from ntm_tracker_tpu_torch.models.core import MemoryCore, make_core
from ntm_tracker_tpu_torch.models.vgg import VGG_MEAN
from ntm_tracker_tpu_torch.tracking.tracker import (
    _to_device,
    build_frame_step,
    decode_head,
    decode_region,
    first_frame_gt,
    region_geometry,
)
from ntm_tracker_tpu_torch.train.optim import tree_map


@dataclasses.dataclass
class _Track:
    image_size: Tuple[int, int]
    normalized_bbox: Any = None
    cropbox: Any = None
    transformation: Any = None


def _write_rows(state, rows: torch.Tensor, source):
    """state with its batch rows `rows` replaced by source's rows, out of
    place: source has one row per entry of `rows`."""
    return tree_map(lambda cur, new: cur.index_copy(0, rows, new), state, source)


class FleetTracker:
    """N-slot batched streaming tracker. Runs on cuda unless `device`
    names another device."""

    def __init__(
        self,
        cfg: TrackerConfig,
        vgg_params: Any,
        params: Any,
        capacity: int = 16,
        core: Optional[MemoryCore] = None,
        delimiter_first: bool = False,
        device=None,
        mesh: Any = None,
        serving_model: Any = None,
    ):
        """serving_model: a tools/export_serving.ServingModel exported with
        --batch == capacity; its programs replace the live frame step
        (vgg_params, params and core unused). Build it with from_serving.

        mesh: a parallel.mesh.Mesh; capacity / mesh.size slots on each of
        its devices (`device` unused). With more than one device the
        shards are FleetTrackers of their own (self.shards), each with its
        state; slot numbers run over them in mesh order."""
        self.cfg = cfg
        self.capacity = capacity
        self._serving = serving_model
        self.shards = None
        if mesh is not None:
            if serving_model is not None:
                raise ValueError("mesh-sharded fleets need the live frame step; an exported artifact bakes an "
                                 "unsharded program")
            if capacity % mesh.size:
                raise ValueError(f"capacity {capacity} must divide over the {mesh.size}-device mesh")
            if mesh.size > 1:
                self._per_shard = capacity // mesh.size
                self.shards = [FleetTracker(cfg, vgg_params, params, self._per_shard, core, delimiter_first, device=d)
                               for d in mesh.devices]
                return
            device = mesh.devices[0]
        if serving_model is not None:
            baked = serving_model.meta.get("batch")
            if baked != capacity:
                raise ValueError(
                    f"serving artifact bakes batch {baked} but fleet capacity is {capacity}; use "
                    f"FleetTracker.from_serving (capacity comes from the file) or re-export with export-serving "
                    f"--batch {capacity}")
            self.device = serving_model.device
            self.core = core
            self._init_full = serving_model.init_state()  # leaves at capacity
            self._step_first, self._step_rest = serving_model.first, serving_model.step
        else:
            self.device = resolve_device(device)
            self.core = core or make_core(cfg)
            self.params = _to_device(params, self.device)
            self._step_first, self._step_rest = build_frame_step(
                cfg, self.core, vgg_params, self.params, delimiter_first=delimiter_first, device=self.device
            )
        self._mean = torch.as_tensor(VGG_MEAN, device=self.device)
        self.state = self._fresh_state(capacity)
        self._tracks: List[Optional[_Track]] = [None] * capacity

    @classmethod
    def from_serving(cls, model):
        """Fleet-serve an exported artifact (export-serving --batch N):
        capacity, geometry, token order, weights and programs all come from
        the file."""
        from ntm_tracker_tpu_torch.tools.export_serving import config_from_meta

        meta = model.meta
        return cls(config_from_meta(meta), None, None, capacity=meta["batch"],
                   delimiter_first=meta["delimiter_first"], serving_model=model)

    def _fresh_state(self, n: int):
        """The learnable initial state for n slots. An artifact bakes it at
        capacity, every slot the same state, so n slots are a slice."""
        if self._serving is not None:
            return tuple(leaf[:n] for leaf in self._init_full)
        with torch.no_grad():
            return self.core.init_state(self.params, n)

    def _crop(self, images: np.ndarray, cropboxes) -> torch.Tensor:
        """Same-shaped frames [n,H,W,3] and their cropboxes -> crops
        [n,S,S,3] on the device. The VGG mean is subtracted before the
        crop, so out-of-image samples are 0 in network space."""
        d = self.cfg.data
        imgs = torch.as_tensor(images, device=self.device).float() - self._mean
        boxes = torch.as_tensor(np.asarray(cropboxes, np.float32), device=self.device)
        return crop_and_resize_mm(imgs, boxes, (d.crop_size, d.crop_size))

    # -- slot management ------------------------------------------------------
    def _slot_geometry(self, t: _Track, region_xywh) -> None:
        t.normalized_bbox, t.cropbox, t.transformation = region_geometry(
            self.cfg.data, t.image_size, region_xywh
        )

    def add(self, image: np.ndarray, region_xywh) -> int:
        """Claim a slot and present the target-indicated first frame (a
        frame step at B=1, whose state is written into the slot)."""
        if self.shards is not None:
            for i, shard in enumerate(self.shards):
                if None in shard._tracks:
                    return i * self._per_shard + shard.add(image, region_xywh)
            raise RuntimeError("fleet is full")
        slot = next((i for i, t in enumerate(self._tracks) if t is None), None)
        if slot is None:
            raise RuntimeError("fleet is full")
        h, w, _ = image.shape
        t = _Track(image_size=(w, h))
        self._slot_geometry(t, region_xywh)
        self._tracks[slot] = t
        gt = first_frame_gt(self.cfg, t.normalized_bbox, t.transformation)
        _, stepped = self._step_first(
            self._crop(image[None], [t.cropbox]),
            torch.as_tensor(gt.reshape(1, -1), device=self.device),
            self._fresh_state(1),
        )
        self.state = _write_rows(self.state, torch.tensor([slot], device=self.device), stepped)
        return slot

    def remove(self, slot: int) -> None:
        if self.shards is not None:
            self.shards[slot // self._per_shard].remove(slot % self._per_shard)
            return
        self._tracks[slot] = None
        self.state = _write_rows(self.state, torch.tensor([slot], device=self.device), self._fresh_state(1))

    @property
    def active(self) -> List[int]:
        if self.shards is not None:
            return [i * self._per_shard + s for i, shard in enumerate(self.shards) for s in shard.active]
        return [i for i, t in enumerate(self._tracks) if t is not None]

    # -- stepping -------------------------------------------------------------
    def step(self, images: Dict[int, np.ndarray]) -> Dict[int, tuple]:
        """Advance every active track one frame. images: slot -> HxWx3
        frame (sizes may differ across slots). Returns slot -> (x, y, w, h)
        region for every slot given a frame."""
        if self.shards is not None:
            n, out = self._per_shard, {}
            for i, shard in enumerate(self.shards):
                regions = shard.step({s - i * n: img for s, img in images.items() if s // n == i})
                out.update({i * n + s: r for s, r in regions.items()})
            return out
        d = self.cfg.data
        # same-shaped frames go through one batched crop; crops stay on the
        # device up to the frame step
        by_shape: Dict[tuple, list] = {}
        for i in self.active:
            if i in images:
                by_shape.setdefault(images[i].shape, []).append(i)
        batch = torch.zeros(self.capacity, d.crop_size, d.crop_size, 3, device=self.device)
        for slots in by_shape.values():
            crops = self._crop(np.stack([images[i] for i in slots]), [self._tracks[i].cropbox for i in slots])
            batch.index_copy_(0, torch.tensor(slots, device=self.device), crops)
        prev_state = self.state
        offsets, self.state = self._step_rest(batch, self.state)
        offsets = offsets.cpu().numpy()

        # an active track given no frame keeps its previous state (the
        # batched step advanced every slot on a zero crop)
        skipped = [i for i in self.active if i not in images]
        if skipped:
            rows = torch.tensor(skipped, device=self.device)
            self.state = _write_rows(self.state, rows, tree_map(lambda t: t.index_select(0, rows), prev_state))

        out: Dict[int, tuple] = {}
        init_bbox = geometry.initial_transformed_bbox(d.cropbox_grid, d.bbox_grid)
        for i in self.active:
            if i not in images:
                continue
            t = self._tracks[i]
            region = decode_region(t.transformation, t.image_size, decode_head(self.cfg, init_bbox, offsets[i]))
            self._slot_geometry(t, region)
            out[i] = region
        return out
