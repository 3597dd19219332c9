"""Generate the synthetic mini-Waymo sequence set: per-sequence `.npy`
frames and `<seq>.pkl` infos under `waymo_processed_data_v0_5_0/`, the
ImageSets splits, and `pred_boxes.pkl`, the offline stage-1 proposals of
MPPNet's USE_PREDBOX path (`datasets/waymo/synthetic.py`). Deterministic, so
the set is regenerated instead of checked in; the same files as
`tools/make_mini_waymo.py`, with no JAX.

    python -m pdm_ssd_torch.tools.make_mini_waymo [--root data/waymo]
        [--seqs 1] [--frames 8] [--n_bg 2000] [--seed 0] [--class_name Vehicle]
        [--force]

`configs/waymo_models/mppnet_mini.yaml` reads the set at `data/waymo` (its
ROI_BOXES_PATH names `data/waymo/pred_boxes.pkl`, relative to the repo).
"""
from __future__ import annotations

import argparse
from pathlib import Path

from ..datasets.waymo.synthetic import make_mini_waymo
from .mini_root import fresh_root

REPO = Path(__file__).resolve().parents[2]


def make(root, seqs: int = 1, frames: int = 8, n_bg: int = 2000, seed: int = 0,
         class_name: str = 'Vehicle', force: bool = False) -> list:
    """Write the set under `root` (replacing a set generated there before;
    another non-empty `root` raises unless `force`); returns the
    sequence names."""
    root = fresh_root(root, force)
    return make_mini_waymo(root, n_seq=seqs, n_frames=frames, n_bg=n_bg, seed=seed,
                           with_pred_boxes=True, class_name=class_name)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--root', default=str(REPO / 'data/waymo'))
    ap.add_argument('--seqs', type=int, default=1)
    ap.add_argument('--frames', type=int, default=8)
    ap.add_argument('--n_bg', type=int, default=2000)
    ap.add_argument('--seed', type=int, default=0)
    ap.add_argument('--class_name', default='Vehicle')
    ap.add_argument('--force', action='store_true',
                    help='replace --root even if no mini-set generator wrote it')
    args = ap.parse_args(argv)
    seqs = make(args.root, args.seqs, args.frames, args.n_bg, args.seed, args.class_name,
                args.force)
    print(f'mini-Waymo with {len(seqs)} sequence(s) x {args.frames} frames at {args.root} '
          '(+ pred_boxes.pkl for USE_PREDBOX)')


if __name__ == '__main__':
    main()
