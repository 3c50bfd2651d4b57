"""Writes the JAX-written full-width checkpoint that the port's orbax reader
is held to, on the CPU and on the card (chip_smoke.py's orbax phase):

  tests/fixtures/orbax_ntm_full/<step>/   a JAX CheckpointManager directory of
      one step: {"params", "opt_state"} of OffsetExperiment(TrackerConfig())
      -- the config `train-offsets` builds from its defaults -- after STEPS
      JAX train steps at B=2, L=2 on a seeded synthetic_cached_batch, so
      that the optimizer's ms and mom are not their initial ones and zeros;
  tests/fixtures/orbax_ntm_full_batch.npz   one more batch (B=2, L=2: T=130;
      at L=1 the loss has no predicted frame, so it and its gradient are 0);
  tests/fixtures/orbax_ntm_full.json        each leaf's path, shape, dtype and
      the sha256 of its bytes, and the JAX package's loss and pre-clip
      global gradient norm on that batch from the saved params.

The manager's save_path.txt breadcrumb names the directory it was written
in, so it is removed. Not collected by pytest; run from the repository
root, on the CPU:

    JAX_PLATFORMS=cpu python tests/make_orbax_fixture.py

Regenerating changes no test: the JSON carries every number the tests and
the smoke hold.
"""

from __future__ import annotations

import dataclasses
import hashlib
import importlib.metadata
import json
import os
import shutil
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, "tests", "fixtures")
NAME = "orbax_ntm_full"
STEPS = 2
B, L = 2, 2
TRAIN_SEED, BATCH_SEED, INIT_SEED = 0, 1, 0


def leaf_records(tree, prefix=()) -> list:
    """[{path, shape, dtype, sha256}] of a restored tree's array leaves, in
    key order; the path joins the keys with "/"."""
    if isinstance(tree, dict):
        return [r for k in sorted(tree) for r in leaf_records(tree[k], prefix + (str(k),))]
    if isinstance(tree, (list, tuple)):
        return [r for i, v in enumerate(tree) for r in leaf_records(v, prefix + (str(i),))]
    if tree is None:
        return [{"path": "/".join(prefix), "shape": None, "dtype": None, "sha256": None}]
    a = np.ascontiguousarray(np.asarray(tree))
    return [{"path": "/".join(prefix), "shape": list(a.shape), "dtype": str(a.dtype),
             "sha256": hashlib.sha256(a.tobytes()).hexdigest()}]


def main() -> int:
    sys.path.insert(0, ROOT)
    import jax
    import jax.numpy as jnp
    import optax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_default_matmul_precision", "highest")
    from ntm_tracker_tpu import cli as jcli
    from ntm_tracker_tpu.train.experiments import OffsetExperiment, synthetic_cached_batch
    from ntm_tracker_tpu.train.harness import CheckpointManager

    base = jcli._tracker_config(jcli.build_parser().parse_args(["train-offsets", "--sequences_dir", "-"]), "ntm")
    cfg = dataclasses.replace(base, train=dataclasses.replace(base.train, batch_size=B, sequence_length=L))
    exp = OffsetExperiment(cfg, None)
    params, opt_state = exp.init(jax.random.PRNGKey(INIT_SEED))
    step = jax.jit(exp.make_train_step())
    batch = synthetic_cached_batch(cfg, np.random.RandomState(TRAIN_SEED))
    for _ in range(STEPS):
        params, opt_state, _ = step(params, opt_state, batch)

    out = os.path.join(FIXTURES, NAME)
    shutil.rmtree(out, ignore_errors=True)
    CheckpointManager(out).save(STEPS, {"params": params, "opt_state": opt_state})
    os.remove(os.path.join(out, "save_path.txt"))
    restored = CheckpointManager(out).restore(STEPS)

    nxt = synthetic_cached_batch(cfg, np.random.RandomState(BATCH_SEED))
    stored = {k: np.asarray(v) for k, v in nxt.items()}
    np.savez(os.path.join(FIXTURES, f"{NAME}_batch.npz"), **stored)
    (loss, _), grads = jax.value_and_grad(exp.loss_fn, has_aux=True)(
        restored["params"], {k: jnp.asarray(v) for k, v in stored.items()})

    record = {
        "step": STEPS,
        "config": "TrackerConfig() as train-offsets builds it from its defaults",
        "train": {"steps": STEPS, "batch_size": B, "sequence_length": L, "seed": TRAIN_SEED,
                  "init_seed": INIT_SEED, "batch": "synthetic_cached_batch(cfg, RandomState(seed))"},
        "num_params": int(sum(np.asarray(x).size for x in jax.tree.leaves(restored["params"]))),
        "leaves": leaf_records(restored),
        "next_batch": {"file": f"{NAME}_batch.npz", "seed": BATCH_SEED, "batch_size": B, "sequence_length": L,
                       "total_steps": cfg.total_steps},
        "loss": float(loss),
        "grad_norm": float(optax.global_norm(grads)),
        "written_by": {"orbax-checkpoint": importlib.metadata.version("orbax-checkpoint"),
                       "tensorstore": importlib.metadata.version("tensorstore"),
                       "jax": importlib.metadata.version("jax")},
    }
    with open(os.path.join(FIXTURES, f"{NAME}.json"), "w") as f:
        json.dump(record, f, indent=1)
        f.write("\n")
    size = sum(os.path.getsize(os.path.join(d, n)) for d, _, names in os.walk(out) for n in names)
    print(f"wrote {out} ({size} bytes, {len(record['leaves'])} leaves), loss {record['loss']:.6f}, "
          f"grad norm {record['grad_norm']:.6f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
