"""Generate the synthetic mini-KITTI set: frames, labels, calib and
decodable PNG images (the JAX package's generator's pixels), then the info pickles and the GT database (`create_kitti_infos`).
Seeded, so the set is reproducible instead of checked in; the same defaults
as `tools/make_mini_kitti.py` (64 frames, 3 classes, seed 0), with no JAX.

    python -m pdm_ssd_torch.tools.make_mini_kitti [--root data/kitti] [--frames 64]
        [--force]
"""
from __future__ import annotations

import argparse
from pathlib import Path

from ..datasets.kitti.kitti_dataset import create_kitti_infos
from ..datasets.kitti.synthetic import make_mini_kitti
from ..utils.config import cfg_from_yaml_file
from .mini_root import fresh_root

REPO = Path(__file__).resolve().parents[2]
CLASS_NAMES = ['Car', 'Pedestrian', 'Cyclist']


def make(root, frames: int = 64, n_bg: int = 8000, seed: int = 0,
         classes=tuple(CLASS_NAMES), force: bool = False) -> Path:
    """Write the set under `root` (replacing a set generated there before;
    another non-empty `root` raises unless `force`) and return it."""
    root = fresh_root(root, force)
    make_mini_kitti(root, n_frames=frames, seed=seed, n_bg=n_bg, classes=tuple(classes))
    ds_cfg = cfg_from_yaml_file(str(REPO / 'configs/dataset_configs/kitti_dataset.yaml'))
    ds_cfg.DATA_PATH = str(root)
    create_kitti_infos(ds_cfg, CLASS_NAMES, root, root, workers=1)
    return root


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--root', default=str(REPO / 'data/kitti'))
    ap.add_argument('--frames', type=int, default=64)
    ap.add_argument('--n_bg', type=int, default=8000)
    ap.add_argument('--seed', type=int, default=0)
    ap.add_argument('--classes', default=','.join(CLASS_NAMES),
                    help='comma list; a single class gives the Car-only set of 3 cars a frame')
    ap.add_argument('--force', action='store_true',
                    help='replace --root even if no mini-set generator wrote it')
    args = ap.parse_args(argv)
    root = make(args.root, args.frames, args.n_bg, args.seed, args.classes.split(','), args.force)
    print(f'mini-KITTI with {args.frames} frames at {root}')


if __name__ == '__main__':
    main()
