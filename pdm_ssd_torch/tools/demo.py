"""Per-frame inference demo (counterpart of the JAX package's `tools/demo.py`):

    python -m pdm_ssd_torch.tools.demo --cfg_file configs/kitti_models/pdm_ssd_point.yaml
        --data_path <a .bin / .npy cloud, or a directory of them> [--ext .bin]
        [--ckpt output/.../ckpt/checkpoint_epoch_<n>.pth]
        [--vis 3d|bev|none] [--save_dir DIR] [--device cuda|cpu]

Reads each cloud (a `.bin` of float32 x, y, z, intensity, or a `.npy`), runs
the config's data processing and the model's `predict` one frame at a time,
and prints every detection's class, score and box. `--save_dir` writes
frame_<i>_boxes.npy there, (n, 9) rows of the box's 7 values, its score and
its 1-based label. `--vis` renders each frame as demo_frame_<i>_<vis>.png
(into `--save_dir` when given) and needs matplotlib; `--vis none` does not.
Without `--ckpt` it runs the seeded weights of `build_network`. Runs on the
card unless `--device cpu` is given. Run from the repo root: a config names
its base config relative to it.
"""
from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch

from ..datasets.dataset import DatasetTemplate
from ..models import build_network, get_host_prepare
from ..runtime import trainer
from ..utils import common_utils
from ..utils.config import cfg_from_yaml_file


class DemoDataset(DatasetTemplate):
    """The clouds of a file or a directory, as evaluation samples."""

    def __init__(self, dataset_cfg, class_names, root_path: Path, ext: str = '.bin',
                 logger=None):
        super().__init__(dataset_cfg=dataset_cfg, class_names=class_names, training=False,
                         root_path=root_path, logger=logger)
        if ext not in ('.bin', '.npy'):
            raise ValueError(f'--ext {ext}: the demo reads .bin and .npy clouds')
        self.ext = ext
        self.sample_file_list = sorted(root_path.glob(f'*{ext}')) if root_path.is_dir() \
            else [root_path]

    def __len__(self) -> int:
        return len(self.sample_file_list)

    def __getitem__(self, index: int) -> dict:
        path = self.sample_file_list[index]
        points = np.fromfile(path, dtype=np.float32).reshape(-1, 4) if self.ext == '.bin' \
            else np.load(path)
        return self.prepare_data(data_dict={'points': points, 'frame_id': index})


def main(argv=None) -> list:
    """Returns each frame's detections: dicts of numpy 'boxes' (n, 7),
    'scores' (n,) and 'labels' (n,), 1-based."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--cfg_file', type=str, default='configs/kitti_models/pdm_ssd_point.yaml')
    ap.add_argument('--data_path', type=str, required=True,
                    help='a point cloud file or a directory of them')
    ap.add_argument('--ckpt', type=str, default=None)
    ap.add_argument('--ext', type=str, default='.bin')
    ap.add_argument('--vis', type=str, default='3d', choices=['3d', 'bev', 'none'],
                    help='a render of each frame (needs matplotlib), or none')
    ap.add_argument('--save_dir', type=str, default=None,
                    help='write each frame\'s boxes as .npy (and its render) here')
    ap.add_argument('--device', type=str, default='cuda',
                    help="'cuda' (default; fails where CUDA is unavailable) or 'cpu'")
    args = ap.parse_args(argv)
    device = trainer.resolve_device(args.device)

    cfg = cfg_from_yaml_file(args.cfg_file)
    logger = common_utils.create_logger()
    logger.info('-----------------PDM-SSD demo-------------------------')
    dataset = DemoDataset(cfg.DATA_CONFIG, cfg.CLASS_NAMES, Path(args.data_path),
                          ext=args.ext, logger=logger)
    logger.info(f'Total number of samples: \t{len(dataset)}')
    model = build_network(cfg.MODEL, len(cfg.CLASS_NAMES), cfg.DATA_CONFIG, device=device,
                          class_names=cfg.CLASS_NAMES)
    if args.ckpt:
        epoch = trainer.load_checkpoint(args.ckpt, model)
        logger.info(f'loaded {args.ckpt} (epoch {epoch})')
    host_prepare = get_host_prepare(cfg.MODEL, cfg.DATA_CONFIG)
    predict = trainer.make_predict_step(model)
    save_dir = Path(args.save_dir) if args.save_dir else None
    if save_dir is not None:
        save_dir.mkdir(parents=True, exist_ok=True)

    frames = []
    for idx in range(len(dataset)):
        batch = dataset.collate_batch([dataset[idx]])
        inputs = trainer.to_device_batch(batch, device, trainer.INPUT_KEYS)
        with torch.no_grad():
            if host_prepare is not None:
                inputs = host_prepare(inputs)
            dets = {k: v.cpu().numpy() for k, v in predict(inputs).items()
                    if k in ('pred_boxes', 'pred_scores', 'pred_labels', 'pred_mask')}
        mask = dets['pred_mask'][0].astype(bool)
        boxes, scores = dets['pred_boxes'][0][mask][:, :7], dets['pred_scores'][0][mask]
        labels = dets['pred_labels'][0][mask].astype(np.int64)
        frames.append({'boxes': boxes, 'scores': scores, 'labels': labels})
        logger.info(f'frame {idx}: {int(mask.sum())} detections')
        for b, s, lab in zip(boxes, scores, labels):
            logger.info('  %-12s score %.3f box [%.1f %.1f %.1f %.1f %.1f %.1f %.2f]'
                        % (cfg.CLASS_NAMES[int(lab) - 1], s, *b[:7]))
        if save_dir is not None:
            np.save(save_dir / f'frame_{idx}_boxes.npy',
                    np.concatenate([boxes, scores[:, None], labels[:, None]], axis=1))
        if args.vis != 'none':
            from .visual_utils import draw_scenes
            pts = batch['points'][0]
            if 'points_mask' in batch:
                pts = pts[batch['points_mask'][0]]
            name = f'demo_frame_{idx}_{args.vis}.png'
            png = draw_scenes(pts, ref_boxes=boxes, ref_scores=scores, mode=args.vis,
                              save_path=str(save_dir / name) if save_dir else name)
            logger.info(f'  scene render -> {png}')
    logger.info('Demo done.')
    return frames


if __name__ == '__main__':
    main()
