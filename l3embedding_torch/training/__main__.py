"""The port's stage 03: AVC embedding training.

    python -m l3embedding_torch.training [flags] TRAIN_DIR VALID_DIR OUTPUT_DIR

On several cards, one process each (data parallel; each rank on
``cuda:LOCAL_RANK``):

    python -m torch.distributed.run --nproc-per-node N \
        -m l3embedding_torch.training [flags] TRAIN_DIR VALID_DIR OUTPUT_DIR

The flags and positionals of ``03_train_embedding.py`` (reference
03_train_embedding.py:16-157), plus ``--device`` (default cuda).
"""

import argparse

import torch.distributed as dist

from ..parallel import initialize_distributed
from .loop import train


def parse_arguments(argv=None):
    parser = argparse.ArgumentParser(
        description="Train an L3-like audio-visual correspondence model"
    )
    parser.add_argument("-e", "--num-epochs", dest="num_epochs", type=int,
                        default=150, help="Maximum number of training epochs")
    parser.add_argument("-tes", "--train-epoch-size", dest="train_epoch_size",
                        type=int, default=512,
                        help="Number of training batches per epoch")
    parser.add_argument("-ves", "--validation-epoch-size",
                        dest="validation_epoch_size", type=int, default=1024,
                        help="Number of validation batches per epoch")
    parser.add_argument("-tbs", "--train-batch-size", dest="train_batch_size",
                        type=int, default=64, help="Training batch size")
    parser.add_argument("-vbs", "--validation-batch-size",
                        dest="validation_batch_size", type=int, default=64,
                        help="Validation batch size")
    parser.add_argument("-lr", "--learning-rate", dest="learning_rate",
                        type=float, default=1e-4, help="Optimization learning rate")
    parser.add_argument("-mt", "--model-type", dest="model_type", type=str,
                        default="cnn_L3_orig", help="Model type to train")
    parser.add_argument("-ci", "--checkpoint-interval",
                        dest="checkpoint_interval", type=int, default=10,
                        help="Epochs between periodic checkpoints")
    parser.add_argument("-r", "--random-state", dest="random_state", type=int,
                        default=20180123, help="Random seed")
    parser.add_argument("--gpus", dest="gpus", type=int, default=1,
                        help="(compat) Number of accelerators, recorded; the "
                        "run is data parallel over the processes that "
                        "torch.distributed.run starts, one per card")
    parser.add_argument("-gsid", "--gsheet-id", dest="gsheet_id", type=str,
                        help="Google Spreadsheet ID for tracking "
                        "(tracked locally as JSONL)")
    parser.add_argument("-gdan", "--google-dev-app-name",
                        dest="google_dev_app_name", type=str,
                        help="Google Developer App Name (compat)")
    parser.add_argument("-v", "--verbose", dest="verbose", action="store_true",
                        default=False, help="Print detailed messages")
    parser.add_argument("-cmd", "--continue-model-dir",
                        dest="continue_model_dir", type=str,
                        help="Model directory to resume training from")
    parser.add_argument("-lp", "--log-path", dest="log_path", type=str,
                        default=None, help="Log file path")
    parser.add_argument("-nl", "--no-logging", dest="disable_logging",
                        action="store_true", default=False,
                        help="Disable file logging")
    parser.add_argument("--device", dest="device", type=str, default="cuda",
                        help="Device to train on (cuda, cuda:N or cpu)")
    parser.add_argument("--prefetch-batches", dest="prefetch_batches",
                        type=int, default=4,
                        help="Host batches prefetched ahead of the device")
    parser.add_argument("--profile-steps", dest="profile_steps", type=int,
                        default=0,
                        help="Capture a torch.profiler trace of the first N "
                        "train steps into <model_dir>/profile")
    parser.add_argument("--compute-dtype", dest="compute_dtype", type=str,
                        default="float32", choices=["float32", "bfloat16"],
                        help="Tower compute dtype; bfloat16 is the "
                        "mixed-precision fast path (params stay float32)")
    parser.add_argument("--accum-steps", dest="accum_steps", type=int,
                        default=1,
                        help="Gradient-accumulation microbatches per "
                        "optimizer step (large effective batches at "
                        "microbatch activation memory)")
    parser.add_argument("--bn-mode", dest="bn_mode", type=str,
                        default="sync", choices=["sync", "per_replica"],
                        help="BatchNorm statistics scope: 'sync' = the whole "
                        "global batch; 'per_replica' = each process's rows "
                        "(the reference's per-GPU-slice BN), running "
                        "statistics averaged over the processes")
    parser.add_argument("--kapre-batch-global-db", dest="db_batch_global",
                        action="store_true",
                        help="Reproduce kapre<=0.1.x's batch-global dB "
                        "max reference in the audio front-end (reference "
                        "audio_model.py:138-151); default is per-sample")
    parser.add_argument("--sync-checkpoints", dest="async_checkpoints",
                        action="store_false",
                        help="Write checkpoints synchronously in the "
                        "training loop instead of on a background thread")
    parser.add_argument("--no-preemption-handler",
                        dest="handle_preemption", action="store_false",
                        help="Do not install the SIGTERM/SIGINT handler "
                        "that snapshots exact-step state (preempt.json + "
                        "model_preempt.ckpt) and exits cleanly")
    parser.add_argument("train_data_dir", type=str,
                        help="Path to directory of training h5 batch files")
    parser.add_argument("validation_data_dir", type=str,
                        help="Path to directory of validation h5 batch files")
    parser.add_argument("output_dir", type=str,
                        help="Path to directory for model output")
    return vars(parser.parse_args(argv))


def main(argv=None) -> int:
    args = parse_arguments(argv)
    distributed = initialize_distributed()
    try:
        train(**args)
    finally:
        if distributed:
            dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
