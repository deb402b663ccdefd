"""Stage 01 on the port: train/valid/test subset CSVs of an AudioSet-style
corpus (port of the root ``01_create_subsets.py``; reference
01_create_subsets.py:25-126). The same flags, positionals and CSVs:

    python -m l3embedding_torch.cli.create_subsets [-vr 0.1] [-tr 0.1] \\
        [-mp METADATA_GLOB -fp FILTER_CSV] DATA_DIR OUTPUT_DIR PREFIX

writes ``OUTPUT_DIR/PREFIX_{train,valid,test}.csv`` (columns ytid,
audio_filepath, video_filepath, and labels joined with ';' when metadata
is given). The ontology defaults to the repo's ``resources/ontology.json``.
"""

from __future__ import annotations

import argparse
import csv
import logging
import os

from ..data.ontology import DEFAULT_ONTOLOGY
from ..data.subsets import get_subset_split
from ..utils.log import init_console_logger

LOGGER = logging.getLogger("l3embedding_torch.data")


def write_subset_file(path, subset_list):
    if not subset_list:
        LOGGER.warning("Empty subset list for %s", path)
        return
    with open(path, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=list(subset_list[0].keys()))
        writer.writeheader()
        for item in subset_list:
            item = dict(item)
            if "labels" in item:
                item["labels"] = ";".join(item["labels"])
            writer.writerow(item)


def parse_arguments(argv=None):
    parser = argparse.ArgumentParser(
        description="Creates CSVs containing a train-valid-test split for the given dataset")
    parser.add_argument("-vr", "--valid-ratio", dest="valid_ratio", type=float,
                        default=0.1, help="Ratio of dataset used for validation set")
    parser.add_argument("-tr", "--test-ratio", dest="test_ratio", type=float,
                        default=0.1, help="Ratio of dataset used for test set")
    parser.add_argument("-rs", "--random-seed", dest="random_seed", type=int,
                        default=12345678, help="Random seed used for generating split")
    parser.add_argument("-o", "--ontology-path", dest="ontology_path", type=str,
                        default=DEFAULT_ONTOLOGY, help="Path to AudioSet ontology")
    parser.add_argument("-mp", "--metadata-path", dest="metadata_path", type=str,
                        help="Path to metadata csv file(s). Accepts a glob string.")
    parser.add_argument("-fp", "--filter-path", dest="filter_path", type=str,
                        help="Path to filter csv file(s).")
    parser.add_argument("-r", "--random-state", dest="random_state", type=int,
                        default=20171021, help="Random seed used to set the RNG state")
    parser.add_argument("data_dir", type=str, help="Path to directory where data files are stored")
    parser.add_argument("output_dir", type=str,
                        help="Path to directory where output files will be stored")
    parser.add_argument("filename_prefix", type=str, help="Prefix for output subset CSV filenames")
    return parser.parse_args(argv)


def create_subsets(data_dir, output_dir, filename_prefix, valid_ratio=0.1, test_ratio=0.1,
                   random_state=20171021, metadata_path=None, filter_path=None,
                   ontology_path=DEFAULT_ONTOLOGY):
    """Split the corpus and write the three CSVs → their paths (train,
    valid, test). As the root script, the split is seeded by random_state
    (``-r``); ``-rs`` is parsed and unused."""
    splits = get_subset_split(
        data_dir, valid_ratio=valid_ratio, test_ratio=test_ratio, random_state=random_state,
        metadata_path=metadata_path, filter_path=filter_path, ontology_path=ontology_path)
    os.makedirs(output_dir, exist_ok=True)
    paths = []
    for name, subset in zip(("train", "valid", "test"), splits):
        paths.append(os.path.join(output_dir, f"{filename_prefix}_{name}.csv"))
        write_subset_file(paths[-1], subset)
    return tuple(paths)


def main(argv=None):
    init_console_logger(LOGGER, verbose=True)
    args = parse_arguments(argv)
    create_subsets(args.data_dir, args.output_dir, args.filename_prefix,
                   valid_ratio=args.valid_ratio, test_ratio=args.test_ratio,
                   random_state=args.random_state, metadata_path=args.metadata_path,
                   filter_path=args.filter_path, ontology_path=args.ontology_path)


if __name__ == "__main__":
    main()
