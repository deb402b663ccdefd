"""Stage 06 on the port: train a downstream classifier on embedding
features (port of the root ``06_train_classifier.py``; reference
06_train_classifier.py:16-205). The same flags, positionals and ``dest``
names, plus ``--device`` (default cuda; the MLP trains there, svm and rf
run on the host with sklearn):

    python -m l3embedding_torch.cli.train_classifier -mt mlp \\
        OUT/features/us8k/l3/original/music/cnn_L3_melspec2 CLS_OUT 1

writes ``CLS_OUT/classifier/<model_id>/fold<k>/<timestamp>/`` (config.json,
the scalers, model.pkl, results.pkl) as the JAX package's stage does.
sklearn is needed for every model type (the feature scalers).
"""

from __future__ import annotations

import argparse

from ..classifier.train import train


def parse_arguments(argv=None) -> dict:
    parser = argparse.ArgumentParser(
        description="Train an urban sound classification model"
    )
    parser.add_argument("-e", "--num-epochs", dest="num_epochs", type=int,
                        default=150, help="Maximum number of training epochs")
    parser.add_argument("-tbs", "--train-batch-size", dest="train_batch_size",
                        type=int, default=64, help="Training batch size")
    parser.add_argument("-eap", "--early-stopping-patience", dest="patience",
                        type=int, default=20,
                        help="Early-stopping patience (epochs)")
    parser.add_argument("-ps", "--parameter-search", dest="parameter_search",
                        action="store_true",
                        help="If set, run hyperparameter grid search")
    parser.add_argument("-psnv", "--parameter-search-no-valid-fold",
                        dest="parameter_search_valid_fold",
                        action="store_false", default=True,
                        help="If set, search uses a stratified split of train "
                        "instead of the valid fold")
    parser.add_argument("-psvr", "--parameter-search-valid-ratio",
                        dest="parameter_search_valid_ratio", type=float,
                        default=0.15,
                        help="Validation ratio for search without valid fold")
    parser.add_argument("-pstwv", "--parameter-search-train-without-valid",
                        dest="parameter_search_train_with_valid",
                        action="store_false", default=True,
                        help="If set, final model trains without the valid fold")
    parser.add_argument("-lr", "--learning-rate", dest="learning_rate",
                        type=float, default=1e-4, help="MLP learning rate")
    parser.add_argument("-wd", "--weight-decay", dest="weight_decay",
                        type=float, default=1e-5, help="MLP L2 factor")
    parser.add_argument("-npf", "--norm-penalty-factor", dest="C", type=float,
                        default=1.0, help="SVM C")
    parser.add_argument("-sct", "--svm-conv-tolerance", dest="tol", type=float,
                        default=0.00001, help="SVM convergence tolerance")
    parser.add_argument("-smi", "--svm-max-iterations", dest="max_iterations",
                        type=int, default=-1, help="SVM max iterations")
    parser.add_argument("-skt", "--svm-kernel-type", dest="kernel", type=str,
                        default="rbf", help="SVM kernel type")
    parser.add_argument("-rfne", "--rf-num-estimators", dest="n_estimators",
                        type=int, default=100, help="RF tree count")
    parser.add_argument("-gsid", "--gsheet-id", dest="gsheet_id", type=str,
                        help="Spreadsheet ID (tracked locally as JSONL)")
    parser.add_argument("-gdan", "--google-dev-app-name",
                        dest="google_dev_app_name", type=str,
                        help="Google Developer App Name (compat)")
    parser.add_argument("-r", "--random-state", dest="random_state", type=int,
                        default=20171021, help="Random seed")
    parser.add_argument("-v", "--verbose", dest="verbose", action="store_true",
                        default=False, help="Print detailed messages")
    parser.add_argument("-fm", "--feature-mode", dest="feature_mode", type=str,
                        default="framewise", choices=["framewise", "stats"],
                        help="Feature mode")
    parser.add_argument("-mt", "--model-type", dest="model_type", type=str,
                        default="svm", choices=["svm", "rf", "mlp"],
                        help="Classifier type")
    parser.add_argument("-no", "--non-overlap", dest="non_overlap",
                        action="store_true", default=False,
                        help="Remove overlapping frames")
    parser.add_argument("-nocs", "--non-overlap-chunk-size",
                        dest="non_overlap_chunk_size", type=int, default=10,
                        help="Frames per chunk for overlap removal")
    parser.add_argument("-mm", "--min-max", dest="use_min_max",
                        action="store_true", default=False,
                        help="Apply min-max scaling")
    parser.add_argument("--device", dest="device", type=str, default="cuda",
                        help="torch device the MLP trains on (default cuda); "
                        "svm and rf run on the host")
    parser.add_argument("features_dir", type=str,
                        help="Path to feature files directory")
    parser.add_argument("output_dir", type=str,
                        help="Path to output directory")
    parser.add_argument("fold_num", type=int, help="Test fold number (1-based)")
    return vars(parser.parse_args(argv))


def main(argv=None) -> int:
    train(**parse_arguments(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
