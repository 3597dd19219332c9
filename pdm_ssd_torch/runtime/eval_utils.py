"""Evaluation loop: batched predict -> KITTI AP (counterpart of
`pdm_ssd_tpu/runtime/eval_utils.py`).

For each collated numpy batch: the model's inputs go to the device, `predict`
runs, the detections come back to the host, recall is counted against the
ground truth and `generate_prediction_dicts` turns them into KITTI annos.
After the last batch: `result.pkl`, `dataset.evaluation` and the rates.
The last, partial batch runs at its own size.

Under data parallelism each rank predicts its shard of the set (the loader
of `datasets.build_dataloader(..., dist=True)`, whose `ShardSampler` pads
the set by wrap-around to a multiple of the world size), rank 0 gathers
every frame's detections and recall counts (`parallel.gather_to_rank0`),
puts them back in the set's order, drops the padding and runs the evaluator
once; every rank returns its result.
"""
from __future__ import annotations

import pickle
import time
from pathlib import Path

import numpy as np
import torch

from ..ops import iou3d
from ..parallel import ddp
from .prefetch import prefetch_batches
from .trainer import INPUT_KEYS, make_predict_step, resolve_device, to_device_batch

PRED_KEYS = ('pred_boxes', 'pred_scores', 'pred_labels', 'pred_mask')


def _recall_counts(pred_boxes, pred_mask, gt_boxes, gt_mask, thresh_list):
    """Per-sample recall bookkeeping (`detector3d_template.generate_recall_record
    :286-328` analog) on the host, with the port's 3D IoU."""
    counts = {f'recall_{t}': 0 for t in thresh_list}
    gt_num = 0
    for b in range(pred_boxes.shape[0]):
        gts = gt_boxes[b][gt_mask[b]][:, :7]
        preds = pred_boxes[b][pred_mask[b]][:, :7]
        gt_num += len(gts)
        if len(gts) == 0 or len(preds) == 0:
            continue
        iou = iou3d.boxes_iou3d(torch.from_numpy(gts.astype(np.float32)),
                                torch.from_numpy(preds.astype(np.float32))).numpy()
        best = iou.max(axis=1)
        for t in thresh_list:
            counts[f'recall_{t}'] += int((best > t).sum())
    return counts, gt_num


def _sync(device: torch.device) -> None:
    if device.type == 'cuda':
        torch.cuda.synchronize(device)


def eval_one_epoch(model, loader, dataset, class_names, device=None, result_dir=None,
                   logger=None, thresh_list=(0.3, 0.5, 0.7), host_prepare=None) -> dict:
    """Predict over `loader` with `model` (already on `device`; None means the
    card, and raises where CUDA is unavailable) and score the detections.
    `host_prepare` (`models.get_host_prepare(model_cfg, dataset_cfg)`, for a
    voxel model) runs on each batch on the device before its predict; the
    batches move to the device on a worker thread, one ahead
    (`prefetch.prefetch_batches`).
    Returns 'recall/rcnn_<t>', the evaluator's entries, 'infer_fps' (frames
    over the time of `predict` alone, synchronized) and 'loop_fps' (frames
    over the whole loop, loading, map build and host work included); under
    data parallelism the set's frames over the slowest rank's times."""
    device = resolve_device(device)
    result_dir = Path(result_dir) if result_dir is not None else None
    predict = make_predict_step(ddp.unwrap(model))
    sampler = getattr(loader, 'sampler', None)
    sharded = getattr(sampler, 'indices', None) is not None and ddp.is_distributed()
    world, rank = ddp.world_size(), ddp.rank()
    n_set = sampler.n if sharded else float('inf')
    frames = []          # (position in the set, anno, recall counts, gt count)
    infer_time, n_frames = 0.0, 0
    out_dir = result_dir / 'final_result/data' if result_dir is not None else None
    if out_dir is not None:
        out_dir.mkdir(parents=True, exist_ok=True)

    t_loop = time.perf_counter()
    batches = prefetch_batches(loader, lambda b: (b, to_device_batch(b, device, INPUT_KEYS)))
    for i, (batch, inputs) in enumerate(batches):
        if host_prepare is not None:
            inputs = host_prepare(inputs)
        _sync(device)
        t0 = time.perf_counter()
        dets = predict(inputs)
        _sync(device)
        infer_time += time.perf_counter() - t0
        dets = {k: dets[k].cpu().numpy() for k in PRED_KEYS}
        B = batch['batch_size']
        # each sample's position in the set's order; the wrap-around padding
        # of `ShardSampler` comes last in a rank's share and is dropped here
        pos = [rank + (n_frames + b) * world if sharded else n_frames + b for b in range(B)]
        keep = sum(p < n_set for p in pos)
        pred_dicts = [{k: dets[k][b] for k in PRED_KEYS} for b in range(keep)]
        annos = dataset.generate_prediction_dicts(batch, pred_dicts, class_names,
                                                  output_path=out_dir)
        for b in range(keep):
            counts, gt_num = ({}, 0) if 'gt_boxes' not in batch else _recall_counts(
                dets['pred_boxes'][b:b + 1], dets['pred_mask'][b:b + 1],
                batch['gt_boxes'][b:b + 1], batch['gt_mask'][b:b + 1], thresh_list)
            frames.append((pos[b], annos[b], counts, gt_num))
        n_frames += B
        if logger and rank == 0 and i % 50 == 0:
            logger.info(f'eval batch {i}/{len(loader)}')
    loop_time = time.perf_counter() - t_loop

    gathered = ddp.gather_to_rank0((frames, infer_time, loop_time)) if sharded else \
        [(frames, infer_time, loop_time)]
    ret_dict = None
    if rank == 0 or not sharded:
        frames = sorted((f for g in gathered for f in g[0]), key=lambda f: f[0])
        n = len(frames)
        ret_dict = _score(frames, dataset, class_names, result_dir, logger, thresh_list,
                          infer_time / max(n_frames, 1))
        ret_dict['infer_fps'] = n / max(max(g[1] for g in gathered), 1e-9)
        ret_dict['loop_fps'] = n / max(max(g[2] for g in gathered), 1e-9)
    return ddp.broadcast_from_rank0(ret_dict) if sharded else ret_dict


def _score(frames, dataset, class_names, result_dir, logger, thresh_list,
           sec_per_frame: float) -> dict:
    """Recall, `result.pkl` and the evaluator over the frames' annos, in the
    set's order."""
    det_annos = [f[1] for f in frames]
    total_gt = sum(f[3] for f in frames)
    ret_dict = {f'recall/rcnn_{t}': sum(f[2].get(f'recall_{t}', 0) for f in frames)
                / max(total_gt, 1) for t in thresh_list}
    if logger:
        logger.info(f'Generate label finished (predict {sec_per_frame:.4f} s a frame)')
        for t in thresh_list:
            logger.info(f"recall_rcnn_{t}: {ret_dict[f'recall/rcnn_{t}']:.4f}")

    if result_dir is not None:
        with open(result_dir / 'result.pkl', 'wb') as f:
            pickle.dump(det_annos, f)

    result_str, result_dict = dataset.evaluation(det_annos, class_names)
    if logger and result_str:
        logger.info(result_str)
    ret_dict.update(result_dict)
    return ret_dict
