"""Convert a reference Keras ``.h5`` AVC weights file into a ``.ckpt``
(port of the root ``tools/import_keras_checkpoint.py``, same positionals).

Maps the Keras layer weights (multi-GPU-wrapped layouts included) onto the
flax-layout tree with ``compat/keras_import.py`` and writes the weights-only
``.ckpt`` that either package's extractor, ``load_model`` and the ``05``
CLI read. Runs on the host; needs h5py.

    python -m l3embedding_torch.tools.import_keras_checkpoint \\
        model_best_valid_accuracy.h5 cnn_L3_melspec2 out/model.ckpt
"""

from __future__ import annotations

import argparse
import os


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="Convert reference Keras .h5 weights to a .ckpt"
    )
    parser.add_argument("h5_path", help="Keras weights .h5 file")
    parser.add_argument("model_type", help="e.g. cnn_L3_melspec2")
    parser.add_argument("output_path", help="output .ckpt path")
    args = parser.parse_args(argv)

    from ..compat.keras_import import import_avc_weights
    from ..training.checkpoints import save_tree

    variables = import_avc_weights(args.h5_path, args.model_type)
    os.makedirs(os.path.dirname(os.path.abspath(args.output_path)), exist_ok=True)
    save_tree(args.output_path, variables)
    print(f"Wrote {args.output_path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
