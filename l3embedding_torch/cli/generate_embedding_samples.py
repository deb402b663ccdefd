"""Stage 05 on the port: downstream embedding features for us8k / esc50 /
dcase2013 (port of the root ``05_generate_embedding_samples.py``; reference
05_generate_embedding_samples.py:16-219). The same flags and positionals,
the model-path layout inference and the output tree
``features/<dataset>/l3/<pooling>/<subset>/<model_type>/fold<k>/*.npz``,
plus ``--device`` (default cuda; cpu runs the plain versions):

    python -m l3embedding_torch.cli.generate_embedding_samples \\
        -lmp .../embedding/<subset>/<model_type>/<timestamp>/model.ckpt \\
        dcase2013 DATA_DIR OUTPUT_DIR [--int8] [--device cpu]

``--features vggish`` needs no model path: the VGGish baseline
(``models/vggish.py``, weights from ``--vggish-resources-dir``) writes
``features/<dataset>/vggish/fold<k>/*.npz``. ``--features whisper`` neither:
Whisper large-v3's audio encoder (``embed/whisper.py``, weights from
``--whisper-weights``, bf16 with ``--fast``) writes each file's encoder
frame rows, (30 s windows × 1500, 1280), to
``features/<dataset>/whisper/fold<k>/*.npz``.

``--mesh`` replicates the tower on every visible card and splits each
window batch over them. ``--int8`` calibrates the int8 tower on
--int8-calib-files files of the dataset (``embed/quantized.py``);
``--int8-artifact`` loads a calibrated artifact of either package instead.
"""

from __future__ import annotations

import argparse
import glob
import json
import logging
import os

from ..data.usc.datasets import (
    generate_dcase2013_fold_data,
    generate_dcase2013_folds,
    generate_esc50_fold_data,
    generate_esc50_folds,
    generate_us8k_fold_data,
    generate_us8k_folds,
)
from ..data.usc.features import check_feature_type
from ..embed.extract import EmbeddingExtractor
from ..embed.quantized import QuantizedEmbeddingExtractor
from ..embed.whisper import WhisperExtractor
from ..models.vggish import VGGishExtractor
from ..utils.log import init_console_logger

LOGGER = logging.getLogger("l3embedding_torch.cls-data")


def parse_arguments(argv=None) -> dict:
    parser = argparse.ArgumentParser(
        description="Generate embedding features for downstream datasets"
    )
    parser.add_argument("-r", "--random-state", dest="random_state", type=int,
                        default=20171021, help="Random seed")
    parser.add_argument("-v", "--verbose", dest="verbose", action="store_true",
                        default=False, help="Print detailed messages")
    parser.add_argument("-f", "--features", dest="features", type=str,
                        default="l3", help="Type of features ('l3', 'vggish' or 'whisper')")
    parser.add_argument("-lmp", "--l3embedding-model-path",
                        dest="l3embedding_model_path", type=str,
                        help="Path to L3 embedding model weights file")
    parser.add_argument("-lpt", "--l3embedding-pooling-type",
                        dest="l3embedding_pooling_type", type=str,
                        default="original",
                        help="Pooling type for the embedding layer "
                        "('original' or 'short')")
    parser.add_argument("-hs", "--hop-size", dest="hop_size", type=float,
                        default=0.1, help="Hop size in seconds")
    parser.add_argument("-nrs", "--num-random-samples",
                        dest="num_random_samples", type=int,
                        help="(compat) randomized-sampling count")
    parser.add_argument("-g", "--gpus", dest="gpus", type=int, default=0,
                        help="(compat) accelerator count; see --mesh")
    parser.add_argument("--kapre-batch-global-db", dest="db_batch_global",
                        action="store_true",
                        help="Reproduce kapre<=0.1.x's batch-global dB "
                        "quirk when extracting with checkpoints trained "
                        "under it")
    parser.add_argument("--fast", dest="fast", action="store_true",
                        help="bf16 extraction tower")
    parser.add_argument("--device-framing", dest="device_framing",
                        action="store_true",
                        help="Upload each file's PCM once and cut the "
                        "overlapping windows on the device (identical rows)")
    parser.add_argument("--mesh", dest="mesh", action="store_true",
                        help="Replicate the tower on every visible card and "
                        "split each window batch over them; works with the "
                        "f32/bf16 towers and with --int8. Falls back to host "
                        "framing if --device-framing is also set")
    parser.add_argument("--int8", dest="int8", action="store_true",
                        help="int8 post-training-quantized tower (BN folding, "
                        "per-channel weights, calibrated static activation "
                        "scales; embed/quantized.py). Calibrates on "
                        "--int8-calib-files files sampled evenly from the "
                        "dataset, then freezes the scales")
    parser.add_argument("--int8-calib-files", dest="int8_calib_files",
                        type=int, default=8,
                        help="Number of dataset files used for int8 "
                        "activation-scale calibration")
    parser.add_argument("--int8-min-cosine", dest="int8_min_cosine",
                        type=float, default=0.999,
                        help="Refuse to extract if the int8 tower's "
                        "measured min cosine vs the BN-folded f32 tower "
                        "on the calibration windows is below this. 0 "
                        "disables the gate")
    parser.add_argument("--int8-calib-method", dest="int8_calib_method",
                        choices=["amax", "percentile"], default="amax",
                        help="Activation-scale calibration: clip at the "
                        "observed absolute max, or at the 99.99th "
                        "percentile of |activations|")
    parser.add_argument("--int8-artifact", dest="int8_artifact", type=str,
                        help="Load a pre-calibrated int8 artifact "
                        "(save_artifact output) instead of calibrating; the "
                        "gate recorded at export is re-checked against "
                        "--int8-min-cosine. Implies --int8; the artifact's "
                        "front end wins over --int8-dft-bf16. The model "
                        "path is still used for the output layout only")
    parser.add_argument("--int8-save-artifact", dest="int8_save_artifact",
                        type=str,
                        help="After calibrating, export the int8 tower to "
                        "this .npz for later --int8-artifact runs")
    parser.add_argument("--int8-dft-bf16", dest="int8_dft_bf16",
                        action="store_true",
                        help="Keep the front end's DFT in bf16 (the front-end "
                        "kernel) instead of the default s8xs8->s32 stage")
    parser.add_argument("--vggish-resources-dir", dest="vggish_resources_dir", type=str,
                        help="Directory of vggish_model.npz and vggish_pca_params.npz "
                        "(default: resources/vggish of this checkout)")
    parser.add_argument("--whisper-weights", dest="whisper_weights", type=str,
                        help="Whisper encoder weights for --features whisper: Whisper's "
                        ".pt, a torch state dict or .safetensors, in Whisper's or Hugging "
                        "Face's names (default: a seeded random init, with a warning)")
    parser.add_argument("--device", dest="device", type=str, default="cuda",
                        help="torch device (default cuda; cpu runs the plain versions)")
    parser.add_argument("--fold", dest="fold", type=int,
                        help="Fold number to generate; all folds if unset")
    parser.add_argument("-ump", "--us8k-metadata-path",
                        dest="us8k_metadata_path", type=str,
                        help="Path to UrbanSound8K metadata file")
    parser.add_argument("dataset_name", type=str,
                        choices=["us8k", "esc50", "dcase2013"],
                        help="Name of dataset")
    parser.add_argument("data_dir", type=str,
                        help="Path to dataset audio directory")
    parser.add_argument("output_dir", type=str,
                        help="Path to output directory")
    return vars(parser.parse_args(argv))


def _calibration_files(data_dir: str, n_files: int) -> list[str]:
    """n_files .wav files sampled evenly from the sorted dataset."""
    wavs = sorted(glob.glob(os.path.join(data_dir, "**", "*.wav"), recursive=True)) or sorted(
        glob.glob(os.path.join(data_dir, "**", "*.WAV"), recursive=True))
    if not wavs:
        raise ValueError(f"--int8 calibration found no .wav files under {data_dir}")
    n = min(n_files, len(wavs))
    return wavs[:: max(1, len(wavs) // n)][:n]


def build_extractor(args: dict, model_path: str, model_type: str, pooling_type: str):
    devices = None
    if args["mesh"]:
        import torch

        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
        if not devices:
            raise ValueError("--mesh needs at least one visible CUDA device")
        LOGGER.info("Splitting window batches over %d devices", len(devices))
    gate = args["int8_min_cosine"] if args["int8_min_cosine"] > 0 else None
    if args["int8_artifact"]:
        LOGGER.info("Loading int8 artifact %s...", args["int8_artifact"])
        model = QuantizedEmbeddingExtractor.load_artifact(
            args["int8_artifact"], devices=devices, device_framing=args["device_framing"],
            min_cosine=gate, device=args["device"])
        if model.model_type != model_type:
            raise ValueError(
                f"artifact is a {model.model_type} tower "
                f"but the model path names {model_type}"
            )
        return model
    if args["int8"]:
        model = QuantizedEmbeddingExtractor(
            model_path, model_type, pooling_type,
            db_batch_global=args["db_batch_global"],
            device_framing=args["device_framing"],
            devices=devices,
            dft_int8=False if args["int8_dft_bf16"] else None,
            device=args["device"],
        )
        calib = _calibration_files(args["data_dir"], args["int8_calib_files"])
        LOGGER.info("Calibrating int8 scales on %d files...", len(calib))
        model.calibrate_files(calib, hop_size=args["hop_size"],
                              method=args["int8_calib_method"], min_cosine=gate)
        if args["int8_save_artifact"]:
            model.save_artifact(args["int8_save_artifact"])
        return model
    return EmbeddingExtractor(
        model_path, model_type, pooling_type,
        fast=args["fast"],
        db_batch_global=args["db_batch_global"],
        device_framing=args["device_framing"],
        devices=devices,
        device=args["device"],
    )


def main(argv=None) -> int:
    args = parse_arguments(argv)
    init_console_logger(LOGGER, verbose=args["verbose"])
    LOGGER.info("Configuration: %s", args)

    pooling_type = args["l3embedding_pooling_type"]
    model_path = args["l3embedding_model_path"]
    features = args["features"]
    dataset_name = args["dataset_name"]
    fold_num = args["fold"]
    check_feature_type(features)

    if features == "vggish":
        dataset_output_dir = os.path.join(args["output_dir"], "features", dataset_name, features)
        l3embedding_model = VGGishExtractor(args["vggish_resources_dir"], device=args["device"])
    elif features == "whisper":
        dataset_output_dir = os.path.join(args["output_dir"], "features", dataset_name, features)
        l3embedding_model = WhisperExtractor(args["whisper_weights"], fast=args["fast"], device=args["device"])
    else:
        if not model_path:
            raise ValueError("Must provide model path if L3 embedding features are used")
        # Model type and output layout from the model path string
        # (reference 05_generate_embedding_samples.py:143-157):
        # .../embedding/<subset>/<model_type>/<timestamp>/model_*.ckpt
        model_desc_start_idx = model_path.rindex("embedding") + 10
        model_desc_end_idx = os.path.dirname(model_path).rindex("/")
        embedding_desc_str = model_path[model_desc_start_idx:model_desc_end_idx]
        dataset_output_dir = os.path.join(
            args["output_dir"], "features", dataset_name, features,
            pooling_type, embedding_desc_str,
        )
        model_type = embedding_desc_str.split("/")[-1]
        LOGGER.info("Loading embedding model (%s)...", model_type)
        l3embedding_model = build_extractor(args, model_path, model_type, pooling_type)

    os.makedirs(dataset_output_dir, exist_ok=True)
    args["features_dir"] = dataset_output_dir
    with open(os.path.join(dataset_output_dir, f"config_{fold_num}.json"), "w") as f:
        json.dump(args, f)

    common = dict(
        l3embedding_model=l3embedding_model,
        features=features,
        random_state=args["random_state"],
        hop_size=args["hop_size"],
        num_random_samples=args["num_random_samples"],
    )
    data_dir = args["data_dir"]
    if dataset_name == "us8k":
        if not args["us8k_metadata_path"]:
            raise ValueError("Must provide metadata file for UrbanSound8k")
        if fold_num is not None:
            generate_us8k_fold_data(args["us8k_metadata_path"], data_dir, fold_num - 1,
                                    dataset_output_dir, **common)
        else:
            generate_us8k_folds(args["us8k_metadata_path"], data_dir, dataset_output_dir, **common)
    elif dataset_name == "esc50":
        if fold_num is not None:
            generate_esc50_fold_data(data_dir, fold_num - 1, dataset_output_dir, **common)
        else:
            generate_esc50_folds(data_dir, dataset_output_dir, **common)
    else:
        if fold_num is not None:
            generate_dcase2013_fold_data(data_dir, fold_num - 1, dataset_output_dir, **common)
        else:
            generate_dcase2013_folds(data_dir, dataset_output_dir, **common)
    LOGGER.info("Done!")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
