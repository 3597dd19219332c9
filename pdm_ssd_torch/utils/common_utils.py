"""Logger and seeding (copy of the helpers of
`pdm_ssd_tpu/utils/common_utils.py`, itself the non-distributed part of the
reference's `pcdet/utils/common_utils.py`)."""
from __future__ import annotations

import logging
import random

import numpy as np


def create_logger(log_file=None, rank=0, log_level=logging.INFO):
    logger = logging.getLogger(__name__ + f'.rank{rank}')
    logger.setLevel(log_level if rank == 0 else 'ERROR')
    formatter = logging.Formatter('%(asctime)s  %(levelname)5s  %(message)s')
    if not logger.handlers:
        console = logging.StreamHandler()
        console.setLevel(log_level if rank == 0 else 'ERROR')
        console.setFormatter(formatter)
        logger.addHandler(console)
        if log_file is not None:
            file_handler = logging.FileHandler(filename=log_file)
            file_handler.setLevel(log_level if rank == 0 else 'ERROR')
            file_handler.setFormatter(formatter)
            logger.addHandler(file_handler)
    logger.propagate = False
    return logger


def set_random_seed(seed):
    random.seed(seed)
    np.random.seed(seed)

