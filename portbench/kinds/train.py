"""Train traffic: the cached-token train step of
`OffsetExperiment(cfg, image_mode="cropped").make_train_step()` at batch B
and L frames (T = L * (F + 1) cell steps), in a closed loop over a pool
of distinct batches drawn on the card. One unit of work is a trained
frame (B * L a step).

Set-up builds the step with its parameters and optimizer state from the
seed and drives it through its first `warmup_steps` steps, on the pool's
first batches (rows that all differ); the window carries on from there.
The reference follows the first steps from the same parameters and
batches. Compared: `loss_gap`, each of the first `check_steps` steps'
loss; `grad_gap`, the first gradient as the optimizer got it (worked
out from its state after step 1), and `change_gap`, the parameters'
change after step 1, each by the worst leaf: the gap between the
program's norm of a leaf and the reference's, over the reference's norm
of that leaf or of the median leaf, whichever is larger; and the same
two gaps of the median leaf (`grad_gap_median`, `change_gap_median`),
which hold a tighter limit: a leaf whose gradient's sums cancel reads
a worst-leaf gap of its own rounding (PERF.md gives the readings).
Leaves whose reference gradient is under a thousandth of the median
leaf's are left out.

Traffic parameters: batch, sequence_length, image_mode, pool,
warmup_steps, check_steps, reference_block_rows, trace_steps.
"""

from __future__ import annotations

import statistics

import torch

from portbench import traffic, weights
from portbench.reference import model

# a step may run ahead of the device by this many steps before the host
# waits for the oldest (keeps the queue short without a bubble)
IN_FLIGHT = 2


class Runner:
    def __init__(self, run):
        self.run = run
        t = run.traffic
        self.B, self.L = t["batch"], t["sequence_length"]
        self.trace_steps = t["trace_steps"]
        self.steps = 0
        self.pending = []

    def setup(self) -> None:
        run, t = self.run, self.run.traffic
        from portbench import program

        dev = run.device
        cfg = program.tracker_config(run.conf, batch_size=self.B, sequence_length=self.L)
        exp = program.OffsetExperiment(cfg, None, image_mode=t["image_mode"], device=dev)
        self.opt = exp.optimizer()
        self.params0 = weights.core_weights(run.conf, run.seed, dev)
        self.pool = traffic.cached_batches(run.conf, self.B, self.L, t["pool"], run.seed, dev)
        self.train_step = exp.make_train_step()
        self.params, self.opt_state = self.params0, self.opt.init(self.params0)
        self.losses = []
        for k in range(t["warmup_steps"]):
            self._step()
            if k == 0:
                self.opt_state1, self.params1 = self.opt_state, self.params
        self.checked_losses = self.losses[:t["check_steps"]]
        self._drain()

    def _step(self) -> None:
        batch = self.pool[self.steps % len(self.pool)]
        self.params, self.opt_state, metrics = self.train_step(self.params, self.opt_state, batch)
        self.losses.append(metrics["loss"])
        if torch.cuda.is_available() and self.run.device.type == "cuda":
            ev = torch.cuda.Event()
            ev.record()
            self.pending.append(ev)
            if len(self.pending) > IN_FLIGHT:
                self.pending.pop(0).synchronize()
        self.steps += 1

    def _drain(self) -> None:
        if self.run.device.type == "cuda":
            torch.cuda.synchronize(self.run.device)
        self.pending.clear()

    def step(self) -> int:
        self._step()
        return self.B * self.L

    def finish_window(self) -> None:
        """The window's end: every step done and its loss read on the host."""
        self._drain()
        warm = self.run.traffic["warmup_steps"]
        self.window_losses = torch.stack(self.losses[warm:]).cpu() if len(self.losses) > warm else torch.zeros(0)
        if not bool(torch.isfinite(self.window_losses).all()):
            raise RuntimeError("a window step's loss is not finite")

    def release(self) -> None:
        del self.train_step, self.params, self.opt_state, self.losses
        torch.cuda.empty_cache() if torch.cuda.is_available() else None

    def compare(self, tf32: bool = False) -> dict:
        """loss_gap and the gradient's and the change's gaps (see the module
        docstring); with tf32 the reference in TF32 stands in the program's
        place."""
        t = self.run.traffic
        opt = self.run.conf["optimizer"]
        leaves0 = model.leaves(self.params0)
        ref = self._reference(False, t)
        if tf32:
            prog = self._reference(True, t)
        else:
            lr, eps = opt["learning_rate"], opt["epsilon"]
            ms1, mom1 = model.leaves(self.opt_state1["ms"]), model.leaves(self.opt_state1["mom"])
            prog = {"losses": [float(x) for x in self.checked_losses],
                    "grads1": [v * torch.sqrt(s + eps) / lr for v, s in zip(mom1, ms1)],
                    "params1": model.leaves(self.params1)}
        ref_g = [float(g.norm()) for g in ref["grads1"]]
        median = statistics.median(ref_g)
        kept = [i for i, n in enumerate(ref_g) if n >= 1e-3 * median]

        def gaps(prog_norms, ref_norms):
            med = statistics.median(ref_norms[i] for i in kept)
            return [abs(prog_norms[i] - ref_norms[i]) / max(ref_norms[i], med) for i in kept]

        prog_g = [float(g.norm()) for g in prog["grads1"]]
        ref_d = [float((p - p0).norm()) for p, p0 in zip(ref["params1"], leaves0)]
        prog_d = [float((p - p0).norm()) for p, p0 in zip(prog["params1"], leaves0)]
        grad, change = gaps(prog_g, ref_g), gaps(prog_d, ref_d)
        self.detail = {"grad_norms": list(zip(prog_g, ref_g)), "change_norms": list(zip(prog_d, ref_d)),
                       "excluded": [i for i in range(len(ref_g)) if i not in kept],
                       "losses": list(zip(prog["losses"], ref["losses"]))}
        loss_gap = max(abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"]))
        return {"loss_gap": loss_gap, "grad_gap": max(grad), "change_gap": max(change),
                "grad_gap_median": statistics.median(grad), "change_gap_median": statistics.median(change)}

    def _reference(self, tf32: bool, t: dict) -> dict:
        """The reference's first step (loss, clipped gradient, RMSProp
        update) and the losses of the next check_steps - 1 steps, from
        the same parameters and batches."""
        conf, opt = self.run.conf, self.run.conf["optimizer"]
        params = [p.detach() for p in model.leaves(self.params0)]
        ms = [torch.ones_like(p) for p in params]
        mom = [torch.zeros_like(p) for p in params]
        rows = t["reference_block_rows"]
        with model.precision(tf32):
            loss, grads = model.train_gradients(conf, self.params0, self.pool[0], self.L, rows)
            grads1 = model.clip_by_global_norm(grads, opt["max_gradient_norm"])
            params1, ms, mom = model.rmsprop(opt, params, grads1, ms, mom)
            losses, params = [float(loss)], params1
            for k in range(1, t["check_steps"]):
                loss, grads = model.train_gradients(conf, model.rebuild(self.params0, params), self.pool[k], self.L,
                                                    rows, need_grads=k + 1 < t["check_steps"])
                losses.append(float(loss))
                if grads is not None:
                    params, ms, mom = model.rmsprop(opt, params, model.clip_by_global_norm(
                        grads, opt["max_gradient_norm"]), ms, mom)
        return {"losses": losses, "grads1": grads1, "params1": params1}
