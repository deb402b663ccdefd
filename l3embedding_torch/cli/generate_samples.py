"""Stage 02 on the port: pre-sample AVC (audio, frame) pairs into HDF5 batch
files (port of the root ``02_generate_samples.py``; reference
02_generate_samples.py:17-143). The same flags and positionals:

    python -m l3embedding_torch.cli.generate_samples [-bs 64] [-ns 64] \\
        [-mr 2.0] [--augment] [--include-metadata] [-n 4] \\
        [--h5-compression gzip|lzf|none] SUBSET_CSV NUM_SAMPLES OUTPUT_DIR

Worker i samples with the seed random_state + i and writes
``{random_state + i}_{i}_{batch}.h5``; the files equal the root script's.
It runs on the host and needs h5py; its workers are spawned processes.
"""

from __future__ import annotations

import argparse
import functools
import logging
import math

from ..data.sample import sample_and_save
from ..data.utils import map_iterate_in_parallel
from ..utils.log import init_console_logger

LOGGER = logging.getLogger("l3embedding_torch.sampling")


def parse_arguments(argv=None):
    parser = argparse.ArgumentParser(description="Pre-sample videos and audios for L3 model.")
    parser.add_argument("-bs", "--batch-size", dest="batch_size", type=int,
                        default=64, help="Number of examples per training batch")
    parser.add_argument("-ns", "--num-streamers", dest="num_streamers", type=int,
                        default=64, help="Number of concurrently open sample streamers")
    parser.add_argument("-mr", "--mux-rate", dest="mux_rate", type=float,
                        default=2.0, help="Poisson rate for samples taken per streamer")
    parser.add_argument("-a", "--augment", dest="augment", action="store_true", default=False,
                        help="If True, performs data augmentation on audio and images")
    parser.add_argument("-pc", "--precompute", dest="precompute", action="store_true",
                        default=False, help="If True, streamers precompute samples")
    parser.add_argument("-nd", "--num-distractors", dest="num_distractors", type=int,
                        default=1, help="Number of distractors for generating examples")
    parser.add_argument("-im", "--include-metadata", dest="include_metadata",
                        action="store_true",
                        help="If True, includes additional metadata in h5 files")
    parser.add_argument("-mv", "--max-videos", dest="max_videos", type=int,
                        help="Maximum number of videos to use")
    parser.add_argument("-r", "--random-state", dest="random_state", type=int,
                        default=20171021, help="Random seed")
    parser.add_argument("-n", "--num-workers", dest="num_workers", type=int,
                        default=4, help="Number of multiprocessing workers")
    parser.add_argument("-v", "--verbose", dest="verbose", action="store_true",
                        default=False, help="Logs verbose info")
    parser.add_argument("--h5-compression", dest="h5_compression", type=str,
                        default="gzip", choices=["gzip", "lzf", "none"],
                        help="Batch-file compression: gzip (the reference's), lzf "
                        "(faster to decode), none")
    parser.add_argument("subset_path", type=str, help="Path to subset file")
    parser.add_argument("num_samples", type=int, help="(Minimum) number of samples to generate")
    parser.add_argument("output_dir", type=str,
                        help="Path to directory where output files will be stored")
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_arguments(argv)
    init_console_logger(LOGGER, verbose=args.verbose)
    batches_per_worker = int(math.ceil(args.num_samples / (args.num_workers * args.batch_size)))
    worker = functools.partial(
        sample_and_save,
        subset_path=args.subset_path,
        num_batches=batches_per_worker,
        output_dir=args.output_dir,
        num_streamers=args.num_streamers,
        batch_size=args.batch_size,
        random_state=args.random_state,
        precompute=args.precompute,
        num_distractors=args.num_distractors,
        augment=args.augment,
        rate=args.mux_rate,
        max_videos=args.max_videos,
        include_metadata=args.include_metadata,
        compression=None if args.h5_compression == "none" else args.h5_compression,
    )
    map_iterate_in_parallel(range(args.num_workers), worker, processes=args.num_workers)
    LOGGER.info("Done!")


if __name__ == "__main__":
    main()
