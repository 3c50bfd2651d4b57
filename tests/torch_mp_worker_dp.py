"""Worker for test_torch_multiprocess_dp.py: one rank of a 2-process gloo
group on the CPU, taking ONE data-parallel train step of the port through
its real multi-process path (initialize_distributed, process_shard_sequences,
global_batch_from_local over a mesh of two local CPU devices,
parallel_train_step). Imports only the port.

    python tests/torch_mp_worker_dp.py <rank> <world> <port> <weights.npz> <out.npz>

The weights file holds the JAX package's initialized params, optimizer
state and VGG (interop.py's flat keys, "p:", "o:", "v:" prefixes). Writes
the loss, the new params and the reduced pre-clip gradients to out.npz
and prints 'RESULT loss=<x>'.

Not a pytest file (no test_ prefix): launched through subprocess with a
clean environment.
"""

import os
import sys


def main():
    rank, world, port, weights, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4], sys.argv[5]

    import numpy as np
    import torch

    torch.set_num_threads(1)

    from ntm_tracker_tpu_torch import interop
    from ntm_tracker_tpu_torch.config import DataConfig, NTMConfig, TrackerConfig, TrainConfig
    from ntm_tracker_tpu_torch.parallel.distributed import (
        global_batch_from_local,
        initialize_distributed,
        process_shard_sequences,
    )
    from ntm_tracker_tpu_torch.parallel.mesh import make_mesh, parallel_train_step
    from ntm_tracker_tpu_torch.train.experiments import OffsetExperiment, synthetic_offset_batch
    from ntm_tracker_tpu_torch.train.optim import tree_map

    assert initialize_distributed(f"127.0.0.1:{port}", world, rank, device="cpu")
    assert torch.distributed.get_backend() == "gloo"
    # the dataset-shard helper agrees with the live group
    assert process_shard_sequences(list(range(10)))[:1] == [rank]

    cfg = TrackerConfig(
        core="ntm",
        ntm=NTMConfig(output_dim=2, mem_size=16, mem_dim=8, controller_hidden_size=32, read_head_size=2),
        data=DataConfig(crop_size=32, resize_hw=(48, 64), gt_width=2),
        train=TrainConfig(batch_size=4 * world, sequence_length=2),
        num_features=4,
        feature_points=((1, 1), (1, 2), (2, 1), (2, 2)),
    )
    flat = np.load(weights)
    params = interop.params_from_flat({k[2:]: flat[k] for k in flat.files if k.startswith("p:")})
    opt_state = interop.opt_state_from_flat({k[2:]: flat[k] for k in flat.files if k.startswith("o:")})
    vgg = interop.vgg_params_from_flat({k[2:]: flat[k] for k in flat.files if k.startswith("v:")})
    if rank:
        # rank 0's weights reach every rank through the first step's broadcast
        params = tree_map(torch.zeros_like, params)
    exp = OffsetExperiment(cfg, vgg, image_mode="cropped", device="cpu")

    # every rank draws the same global batch (same seed) and keeps its own
    # rows, as a per-rank loader reading a disjoint shard would
    full = synthetic_offset_batch(cfg, np.random.RandomState(0))
    per = full["images"].shape[0] // world
    local = {k: v[rank * per:(rank + 1) * per] for k, v in full.items()}

    mesh = make_mesh(["cpu", "cpu"])
    assert mesh.size == 2 and mesh.group is not None
    assert len(global_batch_from_local(mesh, local)) == 2
    step = parallel_train_step(exp, mesh, keep_grads=True)
    new_params, _opt, metrics = step(params, opt_state, local)
    out_flat = {f"p:{k}": v for k, v in interop.flatten_params(new_params).items()}
    out_flat.update({f"g:{k}": v for k, v in interop.flatten_params(metrics["grads"]).items()})
    np.savez(out, loss=np.float64(metrics["loss"]), **out_flat)
    print(f"RESULT loss={float(metrics['loss']):.8f}", flush=True)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
