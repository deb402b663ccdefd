"""Convert an AVC ``.ckpt`` (written by either package) into a
reference-layout Keras ``.h5`` weights file (port of the root
``tools/export_keras_checkpoint.py``, same positionals).

The inverse of ``import_keras_checkpoint``: a model trained on the port
can be handed back to the 2018 Keras code (reference
l3embedding/model.py:85-128 ``load_model``) or the OpenL3 export notebooks.
The kapre spectrogram layer's DFT/mel kernels are made from ``ops/dsp_ref``
so the file is complete. Runs on the host; needs h5py.

    python -m l3embedding_torch.tools.export_keras_checkpoint \\
        out/model_best_valid_accuracy.ckpt cnn_L3_melspec2 model.h5
"""

from __future__ import annotations

import argparse
import os


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="Convert a .ckpt to reference Keras .h5 weights"
    )
    parser.add_argument("ckpt_path", help="AVC .ckpt file")
    parser.add_argument("model_type", help="e.g. cnn_L3_melspec2")
    parser.add_argument("output_path", help="output .h5 path")
    args = parser.parse_args(argv)

    from ..compat.keras_export import export_model
    from ..models.loading import load_model

    model, _ = load_model(args.ckpt_path, args.model_type, device="cpu")
    os.makedirs(os.path.dirname(os.path.abspath(args.output_path)), exist_ok=True)
    export_model(model, args.model_type, args.output_path)
    print(f"Wrote {args.output_path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
