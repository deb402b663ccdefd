"""Downstream classifier training — the `06_train_classifier` path (port
of ``l3embedding_tpu/classifier/train.py``; reference
classifier/train.py:79-709).

SVM and RF stay sklearn on the host CPU; the MLP runs in torch on
`device` (``classifier/mlp.py``). File-level test evaluation averages frame
probabilities over each file's span and argmaxes (reference
classifier/train.py:155-162). sklearn and joblib are imported inside the
functions that use them, so ``train_mlp`` runs where sklearn is missing;
``train`` needs it for its scalers (``preprocess_split_data``). The run
directory, ``config.json``, the scaler files, ``model.pkl`` (the MLP in
the JAX package's list layout), ``results.pkl`` and the tracker row are
the JAX package's.
"""

from __future__ import annotations

import datetime
import getpass
import json
import logging
import os
import pickle as pk
import random
from itertools import product

import numpy as np

from ..compat.to_jax import mlp_to_jax
from ..data.usc.features import preprocess_split_data
from ..data.usc.folds import get_split
from ..utils.log import init_console_logger
from ..utils.tracker import JSONLTracker
from .metrics import compute_metrics
from .mlp import predict_proba, train_mlp_torch

LOGGER = logging.getLogger("l3embedding_torch.classifier")
LOGGER.setLevel(logging.DEBUG)

DATASET_NUM_CLASSES = {"us8k": 10, "esc50": 50, "dcase2013": 10}


def _file_level_predictions(prob_frame, file_idxs):
    """Mean frame probability per file span → argmax class."""
    preds = []
    for start, end in file_idxs:
        preds.append(prob_frame[start:end].mean(axis=0).argmax())
    return np.array(preds)


def _sklearn_eval(clf, train_data, valid_data, test_data, num_classes,
                  loss_fn=None):
    y_train_pred = clf.predict(train_data["features"])
    train_metrics = compute_metrics(
        train_data["labels"], y_train_pred, num_classes=num_classes
    )
    train_metrics["loss"] = (
        loss_fn(train_data) if loss_fn is not None else 0
    )

    if valid_data:
        y_valid_pred = clf.predict(valid_data["features"])
        valid_metrics = compute_metrics(
            valid_data["labels"], y_valid_pred, num_classes=num_classes
        )
        valid_metrics["loss"] = (
            loss_fn(valid_data) if loss_fn is not None else 0
        )
    else:
        valid_metrics = {}

    if test_data:
        prob = clf.predict_proba(test_data["features"])
        y_test_pred = _file_level_predictions(prob, test_data["file_idxs"])
        test_metrics = compute_metrics(
            test_data["labels"], y_test_pred, num_classes=num_classes
        )
    else:
        test_metrics = {}
    return train_metrics, valid_metrics, test_metrics


def train_svm(train_data, valid_data, test_data, model_dir, C=1.0, kernel="rbf",
              num_classes=10, tol=0.001, max_iterations=-1, verbose=False,
              random_state=12345678, **kwargs):
    """SVC with probability outputs + hinge-loss reporting
    (reference classifier/train.py:79-166)."""
    from sklearn.metrics import hinge_loss
    from sklearn.svm import SVC

    np.random.seed(random_state)
    random.seed(random_state)

    clf = SVC(C=C, probability=True, kernel=kernel, max_iter=max_iterations,
              tol=tol, random_state=random_state, verbose=verbose)
    LOGGER.debug("Fitting SVM to data...")
    clf.fit(train_data["features"], train_data["labels"])

    import joblib

    joblib.dump(clf, os.path.join(model_dir, "model.pkl"))

    classes = np.arange(num_classes)

    def svm_loss(data):
        return hinge_loss(
            data["labels"], clf.decision_function(data["features"]), labels=classes
        )

    train_metrics, valid_metrics, test_metrics = _sklearn_eval(
        clf, train_data, valid_data, test_data, num_classes, loss_fn=svm_loss
    )
    return clf, train_metrics, valid_metrics, test_metrics


def train_rf(train_data, valid_data, test_data, model_dir, n_estimators=100,
             num_classes=10, random_state=12345678, **kwargs):
    """RandomForest (reference classifier/train.py:169-227)."""
    from sklearn.ensemble import RandomForestClassifier

    np.random.seed(random_state)
    random.seed(random_state)

    clf = RandomForestClassifier(
        n_estimators=n_estimators, n_jobs=-1, random_state=random_state
    )
    LOGGER.debug("Fitting RF to data...")
    clf.fit(train_data["features"], train_data["labels"])

    import joblib

    joblib.dump(clf, os.path.join(model_dir, "model.pkl"))
    return (clf,) + _sklearn_eval(clf, train_data, valid_data, test_data,
                                  num_classes)


def train_mlp(train_data, valid_data, test_data, model_dir,
              batch_size=64, num_epochs=100, valid_split=0.15, patience=20,
              learning_rate=1e-4, weight_decay=1e-5, num_classes=10,
              random_state=12345678, verbose=False, device="cuda", **kwargs):
    """The torch MLP on `device` with early stopping + best-checkpoint
    restore (reference classifier/train.py:260-391)."""
    X_valid = valid_data["features"] if valid_data else None
    y_valid = valid_data["labels"] if valid_data else None

    model, history = train_mlp_torch(
        train_data["features"], train_data["labels"],
        X_valid=X_valid, y_valid=y_valid,
        num_classes=num_classes, batch_size=batch_size, num_epochs=num_epochs,
        valid_split=valid_split, patience=patience,
        learning_rate=learning_rate, weight_decay=weight_decay,
        random_state=random_state, verbose=verbose, device=device,
    )

    with open(os.path.join(model_dir, "model.pkl"), "wb") as f:
        pk.dump({"params": mlp_to_jax(model)}, f)
    with open(os.path.join(model_dir, "history_checkpoint.pkl"), "wb") as f:
        pk.dump(
            {"loss": history["train_loss"], "val_loss": history["valid_loss"]}, f
        )

    best = history["best_epoch"]
    train_prob = predict_proba(model, train_data["features"])
    train_metrics = compute_metrics(
        train_data["labels"], train_prob, num_classes=num_classes
    )
    train_metrics = {
        "loss": history["train_loss"][best],
        "loss_history": list(history["train_loss"]),
        "accuracy": history["train_acc"][best],
        "accuracy_history": list(history["train_acc"]),
        "class_accuracy": train_metrics["class_accuracy"],
        "average_class_accuracy": train_metrics["average_class_accuracy"],
    }
    valid_metrics = {
        "loss": history["valid_loss"][best],
        "loss_history": list(history["valid_loss"]),
        "accuracy": history["valid_acc"][best],
        "accuracy_history": list(history["valid_acc"]),
    }
    if valid_data:
        valid_prob = predict_proba(model, valid_data["features"])
        valid_metrics.update(
            compute_metrics(valid_data["labels"], valid_prob,
                            num_classes=num_classes)
        )

    if test_data:
        prob = predict_proba(model, test_data["features"])
        y_test_pred = _file_level_predictions(prob, test_data["file_idxs"])
        test_metrics = compute_metrics(
            test_data["labels"], y_test_pred, num_classes=num_classes
        )
    else:
        test_metrics = {}
    return model, train_metrics, valid_metrics, test_metrics


def train_param_search(train_data, valid_data, test_data, model_dir, train_func,
                       search_space, valid_ratio=0.15, train_with_valid=True,
                       **kwargs):
    """Grid search with best-on-valid selection and optional
    retrain-with-valid (reference classifier/train.py:394-492)."""
    from sklearn.model_selection import StratifiedShuffleSplit

    search_train_metrics = {}
    search_valid_metrics = {}
    search_params = list(search_space.keys())
    LOGGER.info("Starting hyperparameter search on %s.", search_params)

    best_valid_acc = float("-inf")
    best_params = None
    best_clf = None
    best_test_metrics = None

    if valid_data:
        train_data_skf, valid_data_skf = train_data, valid_data
    else:
        splitter = StratifiedShuffleSplit(n_splits=1, test_size=valid_ratio)
        train_idxs, valid_idxs = next(
            splitter.split(train_data["features"], train_data["labels"])
        )
        train_data_skf = {
            "features": train_data["features"][train_idxs],
            "labels": train_data["labels"][train_idxs],
        }
        valid_data_skf = {
            "features": train_data["features"][valid_idxs],
            "labels": train_data["labels"][valid_idxs],
        }

    for params in product(*[search_space[p] for p in search_params]):
        LOGGER.info("Evaluating %s = %s", search_params, params)
        kwargs.update(dict(zip(search_params, params)))
        clf, train_metrics, valid_metrics, test_metrics = train_func(
            train_data_skf, valid_data_skf, test_data, model_dir, **kwargs
        )
        if valid_metrics["accuracy"] > best_valid_acc:
            best_valid_acc = valid_metrics["accuracy"]
            best_params = params
            best_clf = clf
            best_test_metrics = test_metrics
        search_train_metrics[params] = train_metrics
        search_valid_metrics[params] = valid_metrics

    LOGGER.info(
        "Best %s = %s, valid accuracy = %s",
        search_params, best_params, best_valid_acc,
    )
    kwargs.update(dict(zip(search_params, best_params)))

    if train_with_valid:
        if valid_data:
            num = train_data["labels"].size + valid_data["labels"].size
            idxs = np.random.permutation(num)
            merged = {
                "features": np.vstack(
                    (train_data["features"], valid_data["features"])
                )[idxs],
                "labels": np.concatenate(
                    (train_data["labels"], valid_data["labels"])
                )[idxs],
            }
            clf, train_metrics, _, test_metrics = train_func(
                merged, None, test_data, model_dir, **kwargs
            )
        else:
            clf, train_metrics, _, test_metrics = train_func(
                train_data, None, test_data, model_dir, **kwargs
            )
    else:
        clf = best_clf
        train_metrics = dict(search_train_metrics[best_params])
        test_metrics = best_test_metrics

    train_metrics["search"] = search_train_metrics
    train_metrics["search_params"] = search_params
    train_metrics["search_params_best_values"] = best_params

    valid_metrics = {
        "search": search_valid_metrics,
        "search_params": search_params,
        "search_params_best_values": best_params,
    }
    valid_metrics.update(search_valid_metrics[best_params])
    return clf, train_metrics, valid_metrics, test_metrics


def train(features_dir, output_dir, fold_num,
          model_type="svm", feature_mode="framewise",
          train_batch_size=64, patience=20, random_state=20171021,
          parameter_search=False, parameter_search_valid_fold=True,
          parameter_search_valid_ratio=0.15,
          parameter_search_train_with_valid=False,
          gsheet_id=None, google_dev_app_name=None,
          verbose=False, non_overlap=False, non_overlap_chunk_size=10,
          use_min_max=False, device="cuda", **model_args):
    """Orchestration (reference classifier/train.py:495-709): layout,
    config capture, fold split, preprocessing + scaler persistence,
    dispatch, results.pkl, tracker row. `device` is where the MLP trains
    (svm and rf run on the host); it is not part of config.json."""
    if not LOGGER.handlers:
        init_console_logger(LOGGER, verbose=verbose)
    LOGGER.debug("Initialized logging.")

    # Dataset name parsed from the features dir path
    # (reference classifier/train.py:511-516).
    if "features" not in features_dir:
        raise ValueError('Feature directory must contain "features"')
    features_desc_str = features_dir[features_dir.rindex("features") + 9 :]
    dataset_name = features_desc_str.split("/")[0]
    if dataset_name not in DATASET_NUM_CLASSES:
        raise ValueError(
            f"Feature directory must contain name of dataset "
            f"({list(DATASET_NUM_CLASSES)})"
        )

    model_id = os.path.join(
        features_desc_str, feature_mode,
        "non-overlap" if non_overlap else "overlap",
        "min-max" if use_min_max else "no-min-max",
        model_type,
    )
    # Collision-safe run dir (vs the reference's random startup sleep,
    # classifier/train.py:523-524): append pid on timestamp collision.
    base = os.path.join(
        output_dir, "classifier", model_id, f"fold{fold_num}",
        datetime.datetime.now().strftime("%Y%m%d%H%M%S"),
    )
    model_dir = base
    try:
        os.makedirs(model_dir)
    except FileExistsError:
        model_dir = f"{base}-{os.getpid()}"
        os.makedirs(model_dir, exist_ok=True)

    config = {
        "username": getpass.getuser(),
        "features_dir": features_dir,
        "output_dir": output_dir,
        "model_dir": model_dir,
        "model_id": model_id,
        "fold_num": fold_num,
        "parameter_search": parameter_search,
        "parameter_search_valid_fold": parameter_search_valid_fold,
        "parameter_search_valid_ratio": parameter_search_valid_ratio,
        "parameter_search_train_with_valid": parameter_search_train_with_valid,
        "model_type": model_type,
        "feature_mode": feature_mode,
        "train_batch_size": train_batch_size,
        "patience": patience,
        "non_overlap": non_overlap,
        "non_overlap_chunk_size": non_overlap_chunk_size,
        "random_state": random_state,
        "verbose": verbose,
        "gsheet_id": gsheet_id,
        "google_dev_app_name": google_dev_app_name,
    }
    config.update(model_args)
    with open(os.path.join(model_dir, "config.json"), "w") as fp:
        json.dump(config, fp)

    tracker = (
        JSONLTracker(os.path.join(output_dir, "classifier_experiments.jsonl"))
        if gsheet_id
        else None
    )
    if tracker:
        tracker.upsert(dict(config))

    fold_idx = fold_num - 1
    LOGGER.info("Loading data for configuration with test fold %d...", fold_num)
    train_data, valid_data, test_data = get_split(
        features_dir, fold_idx, dataset_name,
        valid=(not parameter_search or parameter_search_valid_fold),
    )

    LOGGER.info("Preprocessing data...")
    min_max_scaler, stdizer = preprocess_split_data(
        train_data, valid_data, test_data,
        feature_mode=feature_mode, non_overlap=non_overlap,
        non_overlap_chunk_size=non_overlap_chunk_size, use_min_max=use_min_max,
    )
    import joblib

    joblib.dump(min_max_scaler, os.path.join(model_dir, "min_max_scaler.pkl"))
    joblib.dump(stdizer, os.path.join(model_dir, "stdizer.pkl"))

    num_classes = DATASET_NUM_CLASSES[dataset_name]
    LOGGER.info("Training %s with fold %d held out", model_type, fold_num)

    search_spaces = {
        "svm": {"C": [0.1, 1, 10, 100, 1000]},
        "rf": {"n_estimators": [100, 500, 1000]},
        "mlp": {
            "learning_rate": [1e-5, 1e-4, 1e-3],
            "weight_decay": [1e-5, 1e-4, 1e-3],
        },
    }
    train_funcs = {"svm": train_svm, "rf": train_rf, "mlp": train_mlp}
    if model_type not in train_funcs:
        raise ValueError(f"Invalid model type: {model_type}")

    common = dict(num_classes=num_classes, random_state=random_state,
                  verbose=verbose)
    if model_type == "mlp":
        common.update(batch_size=train_batch_size, patience=patience, device=device)

    if parameter_search:
        model, train_metrics, valid_metrics, test_metrics = train_param_search(
            train_data, valid_data, test_data, model_dir,
            train_func=train_funcs[model_type],
            search_space=search_spaces[model_type],
            valid_ratio=parameter_search_valid_ratio,
            train_with_valid=parameter_search_train_with_valid,
            **common, **model_args,
        )
    else:
        model, train_metrics, valid_metrics, test_metrics = train_funcs[
            model_type
        ](train_data, valid_data, test_data, model_dir, **common, **model_args)

    results = {"train": train_metrics, "valid": valid_metrics,
               "test": test_metrics}
    LOGGER.info("Done training. Saving results to disk...")
    with open(os.path.join(model_dir, "results.pkl"), "wb") as fp:
        pk.dump(results, fp, protocol=pk.HIGHEST_PROTOCOL)

    if tracker:
        tracker.update(
            model_dir,
            {
                "train_loss": train_metrics.get("loss"),
                "valid_loss": valid_metrics.get("loss"),
                "train_acc": train_metrics.get("accuracy"),
                "valid_acc": valid_metrics.get("accuracy"),
                "train_avg_class_acc": train_metrics.get(
                    "average_class_accuracy"
                ),
                "valid_avg_class_acc": valid_metrics.get(
                    "average_class_accuracy"
                ),
                "test_acc": test_metrics.get("accuracy"),
                "test_avg_class_acc": test_metrics.get(
                    "average_class_accuracy"
                ),
                "test_class_acc": ", ".join(
                    map(str, test_metrics.get("class_accuracy", []))
                ),
            },
        )
    LOGGER.info("Done!")
    return model_dir, results
