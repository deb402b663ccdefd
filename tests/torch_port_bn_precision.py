"""The float64 evidence behind two train-step precision findings, against the
JAX package (ROADMAP Queue 3 items 1 and 2; PERF.md §6).

    python tests/torch_port_bn_precision.py bias
    python tests/torch_port_bn_precision.py export OUT.npz    # on the card
    python tests/torch_port_bn_precision.py leaf [--weights OUT.npz]

``bias``: tiny_L3 steps at 4 and 8 rows; for each conv bias that feeds a
train-mode BN (zero gradient but for rounding), its gradient's largest
|value| over the fed BN's bias gradient's, for the port's f32 step, the same
step with the conv's bias fused into the conv (the conv backward sums its
gradient), JAX's f32 step and the port's float64 step.

``export``: chip_smoke.py's seeded cnn_L3_melspec2 state (Generator seed 5)
in flax's layout, made on the machine that runs it (torch's generator draws
other numbers on other builds). Needs no JAX.

``leaf``: the vision input BN's bias gradient of a cnn_L3_melspec2 f32 step
on chip_smoke's data-parallel batch (``avc_batches(7, 8, seed=31)[0]``),
from ``--weights`` (else the seed-5 state made here): its cosine to the
port's float64 step for the port (one process, and 2 gloo ranks on the
CPU), JAX (one device, and a 2-device mesh); then with the input video
scaled by 1 ± 2^-22 and 1 + 2^-20, the float64 leaf's own move and both
f32 steps' cosines to it. Run with JAX_PLATFORMS=cpu; JAX's mesh needs
``XLA_FLAGS=--xla_force_host_platform_device_count=2`` or more.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.dirname(HERE))

MODEL = "cnn_L3_melspec2"
LEAF = "vision_model/BatchNorm_0/bias"


def cosine(a, b):
    a, b = np.ravel(np.asarray(a, np.float64)), np.ravel(np.asarray(b, np.float64))
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


def ddp_batch():
    """chip_smoke.py::avc_batches(7, 8, seed=31)[0]."""
    rng = np.random.RandomState(31)
    labels = rng.randint(0, 2, (7, 8))
    video = rng.randint(0, 256, (7, 8, 224, 224, 3), dtype=np.uint8)
    audio = (rng.randn(7, 8, 1, 48000) * 3000).astype(np.int16)
    return {"video": video[0], "audio": audio[0],
            "label": np.stack([labels[0], 1 - labels[0]], 1).astype(np.float32)}


def seeded_state(model_type=MODEL, weights=None, dtype=torch.float32):
    from l3embedding_torch.compat.from_jax import avc_from_jax_variables
    from l3embedding_torch.models.registry import build_model
    from l3embedding_torch.training.state import create_train_state

    state = create_train_state(build_model(model_type), torch.Generator().manual_seed(5), 1e-4, torch.float32,
                               "cpu")
    if weights is not None:
        state.model.load_state_dict(avc_from_jax_variables(weights, model_type))
    if dtype == torch.float64:
        state.model.double()
        for m in state.model.modules():
            if isinstance(getattr(m, "dtype", None), torch.dtype):
                m.dtype = torch.float64
    return state


def flax_grads(state, model_type=MODEL):
    from l3embedding_torch.compat.from_jax import avc_leaves

    params = dict(state.model.named_parameters())
    out = {}
    for name, coll, path, layout in avc_leaves(model_type):
        if coll == "params":
            g = params[name].grad.detach().double().numpy()
            out["/".join(path)] = g.transpose(2, 3, 1, 0) if layout == "conv" else g.T if layout == "dense" else g
    return out


def port_grads(batch, model_type=MODEL, weights=None, dtype=torch.float32):
    """The port's step (float64: the loss's backward on the float64 model)."""
    from l3embedding_torch.training.steps import _ce_acc, _inputs, l2_penalty, make_train_step

    state = seeded_state(model_type, weights, dtype)
    tensors = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    if dtype == torch.float64:
        video, audio, labels = (t.double() for t in _inputs(tensors, torch.device("cpu")))
        ce, _ = _ce_acc(state.model(video, audio, train=True), labels)
        (ce + l2_penalty(state.model)).backward()
    else:
        make_train_step()(state, tensors)
    return flax_grads(state, model_type)


def jax_grads(batch, weights, mesh_devices=1, model_type=MODEL):
    import jax
    import jax.numpy as jnp

    from l3embedding_tpu.models import build_model as jax_build_model
    from l3embedding_tpu.parallel import create_mesh, replicate, shard_batch
    from l3embedding_tpu.training.state import AVCTrainState, make_optimizer
    from l3embedding_tpu.training.steps import make_train_step

    tx = make_optimizer(1e-4)
    state = AVCTrainState(step=jnp.zeros((), jnp.int32), params=weights["params"],
                          batch_stats=weights["batch_stats"], opt_state=tx.init(weights["params"]), tx=tx)
    model = jax_build_model(model_type).module()
    if mesh_devices > 1:
        mesh = create_mesh(jax.devices()[:mesh_devices])
        new, _ = make_train_step(model, donate=False, mesh=mesh)(replicate(state, mesh), shard_batch(batch, mesh))
    else:
        new, _ = make_train_step(model, donate=False)(state, batch)

    def walk(tree, prefix=()):
        for k, v in tree.items():
            yield from walk(v, prefix + (k,)) if isinstance(v, dict) else [("/".join(prefix + (k,)), v)]

    return {p: np.asarray(mu, np.float64) / 0.1 for p, mu in walk(jax.tree.map(np.asarray, new.opt_state[0].mu))}


def flax_variables(state, model_type=MODEL):
    from l3embedding_torch.compat.to_jax import avc_to_jax_variables

    return avc_to_jax_variables(state.model, model_type)


def load_variables(path):
    tree = {}
    with np.load(path) as z:
        for k in z.files:
            node = tree
            *head, last = k.split("/")
            for h in head:
                node = node.setdefault(h, {})
            node[last] = z[k]
    return tree


def export(path):
    flat = {}

    def walk(t, prefix=()):
        for k, v in t.items():
            if isinstance(v, dict):
                walk(v, prefix + (k,))
            else:
                flat["/".join(prefix + (k,))] = np.asarray(v, np.float32)

    walk(flax_variables(seeded_state()))
    np.savez(path, **flat)
    print(f"{path}: {len(flat)} arrays, {sum(v.size for v in flat.values())} values")


def rank_main(rank, port, weights_path, out):
    """One of two gloo ranks: the port's sync step on its rows."""
    import torch.distributed as dist

    from l3embedding_torch.parallel import shard_batch
    from l3embedding_torch.training.steps import make_train_step

    torch.set_num_threads(2)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=2, rank=rank)
    weights = load_variables(weights_path) if weights_path else None
    state = seeded_state(weights=weights)
    rows = shard_batch({k: torch.from_numpy(v) for k, v in ddp_batch().items()}, dist.group.WORLD)
    make_train_step(group=dist.group.WORLD)(state, rows)
    if rank == 0:
        np.save(out, flax_grads(state)[LEAF])
    dist.destroy_process_group()


def two_ranks(weights_path, tmp):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    out = os.path.join(tmp, "leaf_2ranks.npy")
    procs = [subprocess.Popen([sys.executable, __file__, "rank", str(r), str(port), weights_path or "", out],
                              env=dict(os.environ, OMP_NUM_THREADS="2")) for r in range(2)]
    if any(p.wait() for p in procs):
        raise SystemExit("a gloo rank failed")
    return np.load(out)


def leaf(weights_path):
    import tempfile

    weights = load_variables(weights_path) if weights_path else flax_variables(seeded_state())
    batch = ddp_batch()
    f64 = port_grads(batch, weights=weights, dtype=torch.float64)[LEAF]
    with tempfile.TemporaryDirectory() as tmp:
        rows = {"port one process": port_grads(batch, weights=weights)[LEAF],
                "port 2 ranks": two_ranks(weights_path, tmp),
                "JAX one device": jax_grads(batch, weights)[LEAF],
                "JAX 2-device mesh": jax_grads(batch, weights, mesh_devices=2)[LEAF]}
    print(f"{LEAF}: float64 {np.array2string(f64, precision=9)}")
    for name, g in rows.items():
        print(f"  {name}: cosine to float64 {cosine(g, f64):.7f}")
    video = (2.0 * (batch["video"].astype(np.float32) / 255.0) - 1.0).astype(np.float32)
    audio = (batch["audio"].astype(np.float32) / 32768.0).astype(np.float32)
    for eps in (2.0 ** -22, -2.0 ** -22, 2.0 ** -20):
        moved = {"video": (video * np.float32(1 + eps)).astype(np.float32), "audio": audio, "label": batch["label"]}
        m64 = port_grads(moved, weights=weights, dtype=torch.float64)[LEAF]
        print(f"  video x (1 + {eps:.3g}): float64 leaf moves to cosine {cosine(m64, f64):.7f}; cosine to it: "
              f"port f32 {cosine(port_grads(moved, weights=weights)[LEAF], m64):.7f}, "
              f"JAX f32 {cosine(jax_grads(moved, weights)[LEAF], m64):.7f}")


def bias():
    import torch.nn.functional as F

    from l3embedding_torch.compat.from_jax import avc_leaves, bn_fed_biases
    from l3embedding_torch.models import towers
    from test_torch_port_train import jax_step, make_batch, variables

    paths = {name: "/".join(path) for name, _, path, _ in avc_leaves("tiny_L3")}
    fed = {paths[c]: paths[b] for c, b in bn_fed_biases("tiny_L3").items()}
    weights = variables("tiny_L3")

    def fused_bias_conv(conv, x, dtype):
        return F.conv2d(x.to(dtype), conv.weight.to(dtype), conv.bias.to(dtype), padding=conv.padding)

    for rows in (4, 8):
        batch = make_batch(rows, seed=7)
        runs = {"port f32": port_grads(batch, "tiny_L3", weights),
                "port f32, bias fused in the conv": None,
                "JAX f32": {"/".join(p): g for p, g in jax_step("tiny_L3", batch)[2].items()},
                "port float64": port_grads(batch, "tiny_L3", weights, torch.float64)}
        real, towers._conv = towers._conv, fused_bias_conv
        try:
            runs["port f32, bias fused in the conv"] = port_grads(batch, "tiny_L3", weights)
        finally:
            towers._conv = real
        for conv_bias, bn_bias in fed.items():
            ratios = ", ".join(f"{name} {np.abs(g[conv_bias]).max() / np.abs(g[bn_bias]).max():.2e}"
                               for name, g in runs.items())
            print(f"{rows} rows, {conv_bias}: {ratios}")


def main():
    torch.set_num_threads(int(os.environ.get("TORCH_THREADS", "8")))
    mode = sys.argv[1] if len(sys.argv) > 1 else ""
    if mode == "rank":
        rank_main(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4] or None, sys.argv[5])
    elif mode == "export":
        export(sys.argv[2])
    elif mode == "leaf":
        leaf(sys.argv[3] if len(sys.argv) > 3 and sys.argv[2] == "--weights" else None)
    elif mode == "bias":
        bias()
    else:
        raise SystemExit(__doc__)


if __name__ == "__main__":
    main()
