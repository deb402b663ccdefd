"""Export a standalone embedding model from a trained AVC checkpoint (port
of the root ``tools/export_embedding_model.py``, same flags).

Slices the requested tower's params and batch statistics out of an AVC
``.ckpt`` (either package's) or reference Keras ``.h5`` and writes them
beside a descriptor JSON that carries what rebuilds the extractor
(model_type, pooling table, front-end quirk flag), the reference's
notebooks/extract_embedding_models_from_avc_models.ipynb as a checkpoint
transform:

    python -m l3embedding_torch.tools.export_embedding_model \\
        runs/embedding/music/cnn_L3_melspec2/<timestamp>/model_best_valid_accuracy.ckpt \\
        --model-type cnn_L3_melspec2 --embedding audio --pooling short \\
        --output openl3_audio_short

writes ``openl3_audio_short.ckpt`` + ``openl3_audio_short.json`` in the JAX
package's format: either package's ``embed.extract.load_exported_embedding``
reads them. The front end has no weights, so ``--embedding frontend``
writes the descriptor alone. Runs on the host.
"""

from __future__ import annotations

import argparse
import json


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("checkpoint", help="AVC .ckpt or Keras .h5")
    p.add_argument("--model-type", required=True)
    p.add_argument("--embedding", default="audio",
                   choices=["audio", "vision", "frontend"])
    p.add_argument("--pooling", default="original",
                   choices=["original", "short"])
    p.add_argument("--kapre-batch-global-db", dest="db_batch_global",
                   action="store_true",
                   help="Record the kapre<=0.1.x batch-global dB quirk in "
                   "the descriptor (checkpoints trained under it)")
    p.add_argument("--output", required=True,
                   help="Output prefix (writes <output>.ckpt + .json)")
    args = p.parse_args(argv)

    from ..compat.to_jax import avc_to_jax_variables
    from ..models.loading import load_model
    from ..models.registry import build_model
    from ..training.checkpoints import save_tree

    spec = build_model(args.model_type)
    desc = {
        "framework": "l3embedding_torch",
        "export": args.embedding,
        "model_type": args.model_type,
        "pooling_type": args.pooling,
        "db_batch_global": bool(args.db_batch_global),
        "audio_input_shape": list(spec.audio_input_shape),
        "video_input_shape": list(spec.video_input_shape),
        "audio_embedding_pooling": {
            k: list(v) for k, v in spec.audio_embedding_pooling.items()
        },
    }

    if args.embedding == "frontend":
        # The DSP front end has no trainable state: the descriptor alone
        # rebuilds it (its configuration follows from model_type).
        with open(args.output + ".json", "w") as f:
            json.dump(desc, f, indent=2)
        print(f"wrote {args.output}.json (front-end has no weights)")
        return 0

    model, _ = load_model(args.checkpoint, args.model_type, device="cpu")
    variables = avc_to_jax_variables(model, args.model_type)
    tower = f"{args.embedding}_model"
    sub_params = variables["params"][tower]
    save_tree(args.output + ".ckpt", {"params": {tower: sub_params},
                                      "batch_stats": {tower: variables["batch_stats"][tower]}})
    n_params = sum(p.numel() for p in getattr(model, tower).parameters())
    desc["n_params"] = int(n_params)
    with open(args.output + ".json", "w") as f:
        json.dump(desc, f, indent=2)
    print(f"wrote {args.output}.ckpt ({n_params:,} params) + {args.output}.json")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
