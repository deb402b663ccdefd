"""One rank of the 4-process tensor-parallel job of
``tests/test_torch_port_tp.py`` (gloo on the CPU, a (data 2, model 2) mesh).

    RANK=r WORLD_SIZE=4 MASTER_ADDR=127.0.0.1 MASTER_PORT=p \\
        python tests/torch_port_tp_worker.py WORK_DIR

WORK_DIR holds what the test wrote: ``tiny_state0.ckpt`` (JAX's initial
tiny_L3 state), ``tiny_batch.npz`` (16 rows), ``mel_state0.ckpt`` (a seeded
cnn_L3_melspec2 state) and ``mel_batch.npz`` (4 rows). Each rank replicates
rank 0's state, splits it with ``tp_shard_state`` on ``create_mesh(2)`` and
takes one step of each scenario (``SCENARIOS``) on its data index's rows.
Rank 0 writes each step's gathered state (``{name}.ckpt``, through
``save_state``, which every rank calls) and its gathered gradients and
metrics (``{name}.npz``); every rank writes ``rank{r}.json``: the SHA-256
of its split slices and of its replicated leaves after each step, the
second tiny step's metrics, the eval step's metrics under TP and under pure
data parallelism on the same 4 ranks, and whether the saved checkpoint
loaded back onto the mesh gives its slices again. The tiny step's state is
also saved as a directory snapshot (``tp_dir``). Imports no JAX.
"""

import hashlib
import json
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from l3embedding_torch.compat.from_jax import avc_leaves  # noqa: E402
from l3embedding_torch.models.registry import build_model  # noqa: E402
from l3embedding_torch.parallel import create_mesh, initialize_distributed, rank, replicate, shard_batch  # noqa: E402
from l3embedding_torch.parallel.tp import gather_tensors, split_leaves, tp_shard_state  # noqa: E402
from l3embedding_torch.training import checkpoints, steps  # noqa: E402
from l3embedding_torch.training.dir_checkpoints import save_state_dir  # noqa: E402
from l3embedding_torch.training.state import create_train_state  # noqa: E402

# name → (model type, accum_steps, db_batch_global)
SCENARIOS = {
    "tp": ("tiny_L3", 1, False),
    "tp_accum2": ("tiny_L3", 2, False),
    "tp_db_global": ("tiny_L3", 1, True),
    "tp_mel": ("cnn_L3_melspec2", 1, False),
}
# model type → (the files' prefix, the learning rate of its state)
STATE0 = {"tiny_L3": ("tiny", 1e-3), "cnn_L3_melspec2": ("mel", 1e-4)}


def fresh_state(work, model_type, mesh=None, db_batch_global=False):
    prefix, lr = STATE0[model_type]
    state = create_train_state(build_model(model_type), torch.Generator().manual_seed(0), lr,
                               device="cpu", db_batch_global=db_batch_global)
    checkpoints.load_state(os.path.join(work, f"{prefix}_state0.ckpt"), state)
    if rank() != 0:
        with torch.no_grad():  # replicate must bring back rank 0's state exactly
            for p in state.model.parameters():
                p.add_(1)
    replicate(state, mesh)
    return state if mesh is None else tp_shard_state(state, mesh)


def digests(state) -> dict:
    """SHA-256 of this rank's split slices and of its replicated leaves."""
    split = split_leaves(state.model_type)
    tensors = {**dict(state.model.named_parameters()), **dict(state.model.named_buffers())}
    out = {"replicated": hashlib.sha256()}
    for name, t in tensors.items():
        data = t.detach().contiguous().numpy().tobytes()
        if name in split:
            out[name] = hashlib.sha256(data).hexdigest()
        else:
            out["replicated"].update(data)
    out["replicated"] = out["replicated"].hexdigest()
    return out


def flax_grads(state) -> dict:
    """The gathered gradients by flax path, in flax's layout."""
    grads = gather_tensors({n: p.grad for n, p in state.model.named_parameters()}, state.model_type,
                           state.model.tp_mesh)
    out = {}
    for name, coll, path, layout in avc_leaves(state.model_type):
        if coll == "params":
            g = grads[name].double().numpy()
            out["/".join(path)] = g.transpose(2, 3, 1, 0) if layout == "conv" else g.T if layout == "dense" else g
    return out


def main():
    work = sys.argv[1]
    out = os.path.join(work, "out")
    os.makedirs(out, exist_ok=True)
    torch.set_num_threads(1)
    assert initialize_distributed(), "the worker runs under RANK / WORLD_SIZE"
    mesh = create_mesh(model_axis=2)
    record = {"mesh": [mesh.data, mesh.model, mesh.data_index, mesh.model_index]}
    batches = {}
    for key in ("tiny", "mel"):
        with np.load(os.path.join(work, f"{key}_batch.npz")) as z:
            batches[key] = {k: torch.from_numpy(z[k]) for k in z.files}
    for name, (model_type, accum_steps, db_batch_global) in SCENARIOS.items():
        batch = shard_batch(batches[STATE0[model_type][0]], mesh)
        state = fresh_state(work, model_type, mesh, db_batch_global)
        step = steps.make_train_step(accum_steps=accum_steps, group=mesh)
        state, metrics = step(state, batch)
        checkpoints.save_state(os.path.join(out, f"{name}.ckpt"), state)
        grads = flax_grads(state)
        record[name] = digests(state)
        if rank() == 0:
            np.savez(os.path.join(out, f"{name}.npz"), **{f"grad:{k}": v for k, v in grads.items()},
                     **{f"metric:{k}": float(v) for k, v in metrics.items()})
        if name == "tp":
            save_state_dir(os.path.join(out, "tp_dir"), state)
            dist.barrier()
            restored = fresh_state(work, model_type, mesh)
            checkpoints.load_state(os.path.join(out, "tp.ckpt"), restored)
            record["reloaded"] = digests(restored)
            record["reloaded_step"] = restored.step
            _, second = step(state, batch)
            record["second_step"] = {k: float(v) for k, v in second.items()}
            tiny = batches["tiny"]
            record["eval_tp"] = {k: float(v) for k, v in steps.make_eval_step(mesh)(
                fresh_state(work, model_type, mesh), shard_batch(tiny, mesh)).items()}
            dp = create_mesh(model_axis=1)
            record["eval_dp"] = {k: float(v) for k, v in steps.make_eval_step(dp)(
                fresh_state(work, model_type, dp), shard_batch(tiny, dp)).items()}
    with open(os.path.join(out, f"rank{rank()}.json"), "w") as f:
        json.dump(record, f)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
