"""Generate the synthetic mini-nuScenes set, LiDAR half: the v1.0 JSON
tables and LiDAR sweeps of one scene (`datasets/nuscenes/synthetic.py`),
then the devkit-free infos. Deterministic, so the set is regenerated instead
of checked in; the same tables, sweeps and infos as
`tools/make_mini_nuscenes.py --no_cams`, with no JAX.

    python -m pdm_ssd_torch.tools.make_mini_nuscenes [--root data/nuscenes]
        [--samples 3] [--max_sweeps 1]

The scene is one of the official mini split's train scenes, so every
sample lands in `nuscenes_infos_<max_sweeps>sweeps_train.pkl` and the val
infos are empty. The CLIs read the set through `--set` (the config's
VERSION names a subdirectory the set does not have; evaluate on the train
infos):

    --set DATA_CONFIG.VERSION "''"
          DATA_CONFIG.INFO_PATH "{'test': ['nuscenes_infos_10sweeps_train.pkl']}"

(with `--max_sweeps 10`, the config's MAX_SWEEPS). CBGS keeps
round(samples / 10) frames for the set's one class: `--samples 80` gives
two training steps of 4.
"""
from __future__ import annotations

import argparse
import shutil
from pathlib import Path

from ..datasets.nuscenes.synthetic import make_mini_nuscenes

REPO = Path(__file__).resolve().parents[2]


def make(root, samples: int = 3, max_sweeps: int = 1) -> Path:
    """Write the set under `root` (replacing what is there) and return it."""
    root = Path(root)
    if root.exists():
        shutil.rmtree(root)
    return make_mini_nuscenes(root, n_samples=samples, max_sweeps=max_sweeps)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--root', default=str(REPO / 'data/nuscenes'))
    ap.add_argument('--samples', type=int, default=3)
    ap.add_argument('--max_sweeps', type=int, default=1)
    args = ap.parse_args(argv)
    root = make(args.root, args.samples, args.max_sweeps)
    print(f'mini-nuScenes with {args.samples} samples at {root} (LiDAR only)')


if __name__ == '__main__':
    main()
