"""Feature-cache train traffic: the train step of kinds/train.py fed by
`train-offsets --feature_cache`'s own loader: `token_batch_iterator`
(the cache's `.npy` tokens, the frame records, the stack) in
`PrefetchIterator`'s worker, which uploads each batch with
`loader.device_batch`; the loop takes the next batch at each step. One
unit of work is a trained frame (B * L a step).

Set-up writes a cache in the port's layout from the seed, `sequences`
sequences of L frames: the records `<dir>/records/train_<s>/<f>.txt|.bin`
and the tokens `<dir>/cache/base/train_<s>/<f>.npy` (float16 [F, C] in
[0, 40)) with the cache's manifest. The directory is made on tmpfs (the
temporary directory where that is tmpfs, else /dev/shm where it has
room, else the temporary directory), so the reads come from memory, as a
node's page cache holds a cache after its first epoch; it is removed at
release (and at exit, where a run fails). The program's `epoch_batches`
reshuffles the sequences every epoch; set-up drives the first
`warmup_steps` steps.

Compared: kinds/train.py's five numbers, on the first `check_steps`
batches the loader delivered, and `batch_gap`: the largest absolute
difference between a delivered batch's tokens, gts and offsets and what
set-up wrote for its frames (each row found by its offsets, which are
distinct draws; a row found nowhere reads inf). The loader copies, so
its limit is 0.

With --trace 1 the runner sets the program's span flag over its traced
steps alone (the loader's worker predates the harness's profiler, so
the profiler cannot turn its spans on), clearing the `train` and
`loader` spans first; the registry then holds the traced steps.

Traffic parameters: batch, sequence_length, image_mode, sequences,
prefetch, warmup_steps, check_steps, reference_block_rows, trace_steps.

The cell, `ntm_offsets.train_feature_cache`, is not in BENCHMARK.json:
its rate and its set-up spread past half their bounds (PERF.md §4);
portbench/tests/test_portbench_train_cache.py holds its entries.
"""

from __future__ import annotations

import atexit
import json
import os
import shutil
import tempfile

import numpy as np
import torch

from portbench import weights
from portbench.kinds import train

# the tmpfs to use where the temporary directory is on another file system
SHM = "/dev/shm"


def _tmpfs(path: str) -> bool:
    """Whether `path` lies on a tmpfs mount (/proc/self/mounts)."""
    path = os.path.realpath(path)
    best, fstype = "", ""
    try:
        with open("/proc/self/mounts") as f:
            for line in f:
                parts = line.split()
                mount = parts[1]
                if (path == mount or path.startswith(mount.rstrip("/") + "/")) and len(mount) > len(best):
                    best, fstype = mount, parts[2]
    except OSError:
        return False
    return fstype == "tmpfs"


def cache_parent(nbytes: int) -> str:
    """Where set-up makes the cache's directory (the module docstring)."""
    tmp = tempfile.gettempdir()
    if _tmpfs(tmp):
        return tmp
    try:
        st = os.statvfs(SHM)
        if _tmpfs(SHM) and os.access(SHM, os.W_OK) and st.f_bavail * st.f_frsize > 2 * nbytes:
            return SHM
    except OSError:
        pass
    return tmp


def write_cache(conf: dict, root: str, sequences: int, L: int, seed: int, device) -> dict:
    """A cache of `sequences` x L frames under root, drawn from the seed
    on `device` a sequence at a time. -> the arrays written: features
    [S, L, F, C] float16, gts [S, L, g, g] and offsets [S, L, 2] float32."""
    g = conf["data"]["gt_width"]
    F, C = conf["num_features"], conf["feature_depth"]
    gen = weights.generator(seed, 30, device)
    gts = torch.rand(sequences, L, g, g, generator=gen, device=device)
    gts = (gts / gts.sum(dim=(2, 3), keepdim=True)).cpu().numpy()
    offsets = ((torch.rand(sequences, L, 2, generator=gen, device=device) - 0.5) * 0.4).cpu().numpy()
    features = np.empty((sequences, L, F, C), np.float16)
    records, tokens = os.path.join(root, "records"), os.path.join(root, "cache", "base")
    for s in range(sequences):
        features[s] = (torch.rand(L, F, C, generator=gen, device=device) * 40).half().cpu().numpy()
        seq = f"train_{s:05d}"
        os.makedirs(os.path.join(records, seq))
        os.makedirs(os.path.join(tokens, seq))
        for f in range(L):
            name = f"{f:06d}"
            rec = os.path.join(records, seq, name)
            gts[s, f].astype(np.float64).tofile(rec + ".bin")
            y, x = (float(v) for v in offsets[s, f])
            with open(rec + ".txt", "w") as fh:
                fh.write(f"0,0,1,1,0.125,0.125,0.875,0.875,frame_{s}_{f}.jpg,{y!r},{x!r}")
            np.save(os.path.join(tokens, seq, name + ".npy"), features[s, f])
    manifest = {"version": 1, "fingerprint": f"seed{seed}", "store_dtype": "float16", "num_features": F,
                "feature_depth": C, "flip": False, "num_frames": sequences * L,
                "crop_size": conf["data"]["crop_size"], "resize_hw": list(conf["data"]["resize_hw"])}
    with open(os.path.join(tokens, "manifest.json"), "w") as fh:
        json.dump(manifest, fh)
    return {"features": features, "gts": gts, "offsets": offsets}


class Runner(train.Runner):
    def setup(self) -> None:
        run, t = self.run, self.run.traffic
        from ntm_tracker_tpu_torch.data.feature_cache import token_batch_iterator, verify_cache
        from ntm_tracker_tpu_torch.data.loader import PrefetchIterator, device_batch
        from ntm_tracker_tpu_torch.data.sequences import get_valid_sequences
        from ntm_tracker_tpu_torch.utils import profiling
        from portbench import program

        self.profiling = profiling
        dev, conf = run.device, run.conf
        nbytes = t["sequences"] * self.L * conf["num_features"] * conf["feature_depth"] * 2
        self.dir = tempfile.mkdtemp(prefix="portbench_cache_", dir=cache_parent(nbytes))
        atexit.register(shutil.rmtree, self.dir, True)
        self.written = write_cache(conf, self.dir, t["sequences"], self.L, run.seed, dev)
        cfg = program.tracker_config(conf, batch_size=self.B, sequence_length=self.L)
        exp = program.OffsetExperiment(cfg, None, image_mode=t["image_mode"], device=dev)
        cache = os.path.join(self.dir, "cache")
        verify_cache(exp.cfg, cache)
        _, seqs, _ = get_valid_sequences(os.path.join(self.dir, "records"), self.L)
        d = cfg.data
        batches = token_batch_iterator(seqs, self.B, cache, d.gt_width, shuffle=True, seed=run.seed,
                                       epochs=1 << 40, cropbox_grid=d.cropbox_grid, bbox_grid=d.bbox_grid)
        self.it = PrefetchIterator(batches, prefetch=t["prefetch"],
                                   device_put=lambda b: device_batch(b, dev, cfg.predict_scale, cfg.scale_range))
        self.opt = exp.optimizer()
        self.params0 = weights.core_weights(conf, run.seed, dev)
        self.train_step = exp.make_train_step()
        self.params, self.opt_state = self.params0, self.opt.init(self.params0)
        self.losses, self.pool = [], []
        for k in range(t["warmup_steps"]):
            self._step()
            if k == 0:
                self.opt_state1, self.params1 = self.opt_state, self.params
        self.checked_losses = self.losses[:t["check_steps"]]
        self._drain()
        self.traced = 0

    def _step(self) -> None:
        batch = next(self.it)
        if len(self.pool) < self.run.traffic["check_steps"]:
            self.pool.append(batch)
        self.params, self.opt_state, metrics = self.train_step(self.params, self.opt_state, batch)
        self.losses.append(metrics["loss"])
        if self.run.device.type == "cuda":
            ev = torch.cuda.Event()
            ev.record()
            self.pending.append(ev)
            if len(self.pending) > train.IN_FLIGHT:
                self.pending.pop(0).synchronize()
        self.steps += 1

    def step(self) -> int:
        tracing = self.run.trace and self.traced < self.trace_steps
        if tracing and self.traced == 0:
            self.profiling.reset("train", "loader")
            self.profiling.enable()
        self._step()
        if tracing:
            self.traced += 1
            if self.traced == self.trace_steps:
                self.profiling.disable()
        return self.B * self.L

    def release(self) -> None:
        """Frees the program and removes the cache; the worker's next read
        then fails, and the batches before it are drained, so its thread
        has ended before the process exits."""
        super().release()
        shutil.rmtree(self.dir, ignore_errors=True)
        try:
            for _ in self.it:
                pass
        except OSError:
            pass
        del self.it

    def compare(self, tf32: bool = False) -> dict:
        out = super().compare(tf32)
        out["batch_gap"] = self.batch_gap()
        return out

    def batch_gap(self) -> float:
        w = self.written
        S, L = w["offsets"].shape[:2]
        where = {(float(y), float(x)): (s, f) for s in range(S) for f in range(L) for y, x in [w["offsets"][s, f]]}
        gap = 0.0
        for batch in self.pool:
            feats = batch["features"].cpu().numpy()
            gts = batch["gts"].cpu().numpy()
            ys, xs = batch["y_offsets"].cpu().numpy(), batch["x_offsets"].cpu().numpy()
            if feats.dtype != np.float16 or len(ys) != self.B * self.L:
                return float("inf")
            for i, (y, x) in enumerate(zip(ys, xs)):
                found = where.get((float(y), float(x)))
                if found is None:
                    return float("inf")
                s, f = found
                gap = max(gap, float(np.abs(feats[i].astype(np.float32) - w["features"][s, f].astype(np.float32)).max()),
                          float(np.abs(gts[i] - w["gts"][s, f]).max()))
        return gap
