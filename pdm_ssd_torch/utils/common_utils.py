"""Logger and seeding (the helpers of `pdm_ssd_tpu/utils/common_utils.py`,
itself the non-distributed part of the reference's
`pcdet/utils/common_utils.py`; the logger also moves its file handler to a
new `log_file`)."""
from __future__ import annotations

import logging
import os
import random

import numpy as np


def create_logger(log_file=None, rank=0, log_level=logging.INFO):
    """The rank's logger, to the console and, with `log_file`, to that file.
    A later call with another `log_file` moves the file handler there, so
    that each CLI run of one process (the train CLI, then the test CLI) logs
    to its own file."""
    logger = logging.getLogger(__name__ + f'.rank{rank}')
    logger.setLevel(log_level if rank == 0 else 'ERROR')
    formatter = logging.Formatter('%(asctime)s  %(levelname)5s  %(message)s')
    files = [h for h in logger.handlers if isinstance(h, logging.FileHandler)]
    if len(files) == len(logger.handlers):
        console = logging.StreamHandler()
        console.setLevel(log_level if rank == 0 else 'ERROR')
        console.setFormatter(formatter)
        logger.addHandler(console)
    target = None if log_file is None else os.path.abspath(log_file)
    for handler in files:
        if handler.baseFilename != target:
            logger.removeHandler(handler)
            handler.close()
    if target is not None and not any(h.baseFilename == target for h in files):
        file_handler = logging.FileHandler(filename=log_file)
        file_handler.setLevel(log_level if rank == 0 else 'ERROR')
        file_handler.setFormatter(formatter)
        logger.addHandler(file_handler)
    logger.propagate = False
    return logger


def set_random_seed(seed):
    random.seed(seed)
    np.random.seed(seed)



def import_pandas(fmt: str):
    """`pandas`, imported for a raw reader of `fmt`; without it an ImportError
    that names the format and what to read instead. pandas is imported only
    here, inside the readers that need it: a machine without it (the card's
    has none) reads the `.npy` / `.bin` sweeps that info pickles name."""
    try:
        import pandas
    except ImportError as err:
        raise ImportError(f'reading {fmt} needs pandas, which is not installed here; write the '
                          'sweeps as .npy or .bin files and name those (with gt_boxes and '
                          'gt_names) in the info pickles, which the dataset reads without '
                          'pandas') from err
    return pandas
