"""AudioSet subset curation: pair audio/video files, filter by ontology
labels, split train/valid/test (a copy of ``l3embedding_tpu/data/subsets.py``;
reference data/avc/subsets.py:30-207). The split CSVs equal the JAX
package's row for row.

Behavioral note: the reference's `include_children` label filter has a
copy-paste bug — it tests whether the *filter* node is a descendant of
itself (reference subsets.py:157-162: `label_node` is looked up from the
filter string, not the example's label), so child expansion never
matches. We implement the intended semantics (match when an example
label is a descendant of the filter label); pass
`compat_buggy_children=True` to reproduce the reference's no-op
behavior for dataset bit-parity with historical runs.
"""

from __future__ import annotations

import glob
import logging
import os
import random
from collections import OrderedDict

from .ontology import ASOntology
from .utils import read_csv_as_dicts

LOGGER = logging.getLogger("l3embedding_torch.data")
LOGGER.setLevel(logging.DEBUG)


def get_filename(path: str) -> str:
    return os.path.splitext(os.path.basename(path))[0]


def get_ytid_from_filename(filename: str) -> str:
    # Filenames are '<ytid>_<start>_<end>'; ytid may itself contain '_'.
    first = filename.rindex("_")
    second = filename.rindex("_", 0, first)
    return filename[:second]


def load_metadata(metadata_path: str) -> dict:
    """Parse AudioSet segment CSVs (supports globs). Rows:
    ytid, start_seconds, end_seconds, positive_labels
    with a 3-line '# ...' header (reference subsets.py:30-52)."""
    metadata = {}
    for path in glob.glob(metadata_path):
        with open(path) as f:
            fields = None
            for idx, line in enumerate(f):
                if idx in (0, 1):
                    continue
                if idx == 2:
                    fields = [
                        fld.strip() for fld in line.lstrip("# ").rstrip().split(", ")
                    ]
                    continue
                row = [val.strip() for val in line.strip().split(", ")]
                entry = dict(zip(fields[1:], row[1:]))
                entry["positive_labels"] = entry["positive_labels"].strip('"').split(
                    ","
                )
                entry["start_seconds"] = float(entry["start_seconds"])
                entry["end_seconds"] = float(entry["end_seconds"])
                metadata[row[0]] = entry
    return metadata


def _label_filter_match(item_labels, flt, ontology, compat_buggy_children):
    string = flt["string"]
    if string.lower() in item_labels:
        return True
    include_children = flt.get("include_children", "false").lower() == "true"
    if not include_children or ontology is None:
        return False
    filter_node = ontology.get_node_by_name(string)
    if compat_buggy_children:
        # Reference subsets.py:157-162 compares the filter node with
        # itself once per label — never a match for acyclic ontologies.
        return any(
            filter_node.is_child(filter_node) for _ in item_labels
        )
    for label in item_labels:
        try:
            label_node = ontology.get_node_by_name_ci(label)
        except ValueError:
            continue
        if filter_node.is_child(label_node):
            return True
    return False


def apply_filters(file_list, filters, ontology=None, compat_buggy_children=False):
    """Accept/reject rules, first-match-wins for rejects
    (reference subsets.py:123-180): a reject match drops the file
    immediately; any accept match keeps it; with no accept filters at
    all, files are kept by default."""
    has_accept = any(f["accept_reject"].lower() == "accept" for f in filters)
    out = []
    for item in file_list:
        labels = item.get("labels", [])
        accept = None
        for flt in filters:
            is_accept = flt["accept_reject"].lower() == "accept"
            if flt["filter_type"] == "ytid":
                match = item["ytid"] == flt["string"]
            elif flt["filter_type"] == "label":
                match = _label_filter_match(
                    labels, flt, ontology, compat_buggy_children
                )
            else:
                raise ValueError(f"unknown filter_type {flt['filter_type']!r}")
            if is_accept:
                if accept is None and match:
                    accept = True
            elif match:
                accept = False
                break
        if accept is None:
            accept = not has_accept
        if accept:
            out.append(item)
    return out


def get_file_list(
    data_dir,
    metadata_path=None,
    filter_path=None,
    ontology_path=None,
    compat_buggy_children=False,
):
    """Pair audio/ and video/ files by basename; optionally attach
    ontology label names and apply filters (reference subsets.py:55-183).
    """
    contents = set(os.listdir(data_dir))
    if "audio" in contents and "video" in contents:
        audio_files = glob.glob(f"{data_dir}/audio/*")
        video_files = glob.glob(f"{data_dir}/video/*")
    else:
        # recursive=True: the reference's bare '**' (subsets.py:77-78)
        # silently degenerates to one directory level in Python's glob;
        # recursive matching is a strict superset (zero or more levels),
        # so shallow corpora match identically and deeper ones now work.
        audio_files = glob.glob(f"{data_dir}/**/audio/*", recursive=True)
        video_files = glob.glob(f"{data_dir}/**/video/*", recursive=True)

    audio_paths = {get_filename(p): p for p in audio_files}
    video_paths = {get_filename(p): p for p in video_files}
    valid = sorted(set(audio_paths) & set(video_paths))

    ontology = None
    metadata = None
    if metadata_path:
        if not ontology_path:
            raise ValueError("Must provide ontology path to filter")
        metadata = load_metadata(metadata_path)
        ontology = ASOntology(ontology_path)

    file_list = []
    for filename in valid:
        ytid = get_ytid_from_filename(filename)
        item = OrderedDict()
        item["ytid"] = ytid
        item["audio_filepath"] = audio_paths[filename]
        item["video_filepath"] = video_paths[filename]
        if metadata is not None:
            item["labels"] = [
                ontology.get_node(lbl).name.lower()
                for lbl in metadata[ytid]["positive_labels"]
            ]
        file_list.append(item)

    if metadata_path and filter_path:
        filters = read_csv_as_dicts(filter_path)
        file_list = apply_filters(
            file_list, filters, ontology, compat_buggy_children
        )

    LOGGER.info("Total videos used: %d", len(file_list))
    return file_list


def get_subset_split(
    data_dir,
    valid_ratio=0.1,
    test_ratio=0.1,
    random_state=12345678,
    metadata_path=None,
    filter_path=None,
    ontology_path=None,
):
    """Seeded shuffle + ratio split → (train, valid, test) lists
    (reference subsets.py:186-207)."""
    rng = random.Random(random_state)
    file_list = get_file_list(
        data_dir,
        metadata_path=metadata_path,
        filter_path=filter_path,
        ontology_path=ontology_path,
    )
    rng.shuffle(file_list)
    n = len(file_list)
    n_valid = int(n * valid_ratio)
    n_test = int(n * test_ratio)
    valid_list = file_list[:n_valid]
    test_list = file_list[n_valid : n_valid + n_test]
    train_list = file_list[n_valid + n_test :]
    return train_list, valid_list, test_list
