"""Generate a seeded mini set of ONCE, Argoverse 2, Lyft, Pandaset or the
custom layout (`datasets/<set>/synthetic.py`): two splits of `--frames`
frames each, with the infos (and, for the custom set, the GT database)
their datasets read. The set is regenerated instead of downloaded.

    python -m pdm_ssd_torch.tools.make_mini_sets --set once
        [--root data/once] [--frames 8] [--n_bg 6000] [--seed 0] [--force]

The tool writes a marker file into the root it generates and replaces only
a root that holds it (or an empty one): another directory, as a real set
at the default root would be, raises unless `--force` is given.
`utils/synthetic.flagship_on(set, root)` is the flagship's config on the set.
"""
from __future__ import annotations

import argparse
from pathlib import Path

from ..datasets.argo2.synthetic import make_mini_argo2
from ..datasets.custom.synthetic import make_mini_custom
from ..datasets.lyft.synthetic import make_mini_lyft
from ..datasets.once.synthetic import make_mini_once
from ..datasets.pandaset.synthetic import make_mini_pandaset
from .mini_root import fresh_root

REPO = Path(__file__).resolve().parents[2]
GENERATORS = {'once': make_mini_once, 'argo2': make_mini_argo2, 'lyft': make_mini_lyft,
              'pandaset': make_mini_pandaset, 'custom': make_mini_custom}


def make(set_name: str, root, frames: int = 8, n_bg: int = 6000, seed: int = 0,
         force: bool = False) -> Path:
    """Write the set under `root` (replacing a set generated there before;
    another non-empty `root` raises unless `force`) and return it."""
    root = fresh_root(root, force)
    return GENERATORS[set_name](root, n_frames=frames, n_bg=n_bg, seed=seed)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--set', required=True, choices=sorted(GENERATORS))
    ap.add_argument('--root', default=None, help='default data/<set>')
    ap.add_argument('--frames', type=int, default=8, help='frames a split')
    ap.add_argument('--n_bg', type=int, default=6000, help='ground points a frame')
    ap.add_argument('--seed', type=int, default=0)
    ap.add_argument('--force', action='store_true',
                    help='replace --root even if no mini-set generator wrote it')
    args = ap.parse_args(argv)
    root = make(args.set, args.root or REPO / 'data' / args.set, args.frames, args.n_bg,
                args.seed, args.force)
    print(f'mini {args.set} set with {args.frames} frames a split at {root}')


if __name__ == '__main__':
    main()
