"""Evaluation loop: batched predict -> KITTI AP (counterpart of
`pdm_ssd_tpu/runtime/eval_utils.py`).

For each collated numpy batch: the model's inputs go to the device, `predict`
runs, the detections come back to the host, recall is counted against the
ground truth and `generate_prediction_dicts` turns them into KITTI annos.
After the last batch: `result.pkl`, `dataset.evaluation` and the rates.
There is no mesh and no padding: the last, partial batch runs at its own
size.
"""
from __future__ import annotations

import pickle
import time
from pathlib import Path

import numpy as np
import torch

from ..ops import iou3d
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
    voxel model) runs on each batch on the device before its predict.
    Returns 'recall/rcnn_<t>', the evaluator's entries, 'infer_fps' (frames
    over the time of `predict` alone, synchronized) and 'loop_fps' (frames
    over the whole loop, loading, map build and host work included)."""
    device = resolve_device(device)
    result_dir = Path(result_dir) if result_dir is not None else None
    predict = make_predict_step(model)
    det_annos = []
    recall_totals = {f'recall_{t}': 0 for t in thresh_list}
    total_gt, infer_time, n_frames = 0, 0.0, 0
    out_dir = result_dir / 'final_result/data' if result_dir is not None else None
    if out_dir is not None:
        out_dir.mkdir(parents=True, exist_ok=True)

    t_loop = time.perf_counter()
    for i, batch in enumerate(loader):
        inputs = to_device_batch(batch, device, INPUT_KEYS)
        if host_prepare is not None:
            inputs = host_prepare(inputs)
        _sync(device)
        t0 = time.perf_counter()
        dets = predict(inputs)
        _sync(device)
        infer_time += time.perf_counter() - t0
        dets = {k: dets[k].cpu().numpy() for k in PRED_KEYS}
        n_frames += batch['batch_size']

        if 'gt_boxes' in batch:
            counts, gt_num = _recall_counts(dets['pred_boxes'], dets['pred_mask'],
                                            batch['gt_boxes'], batch['gt_mask'], thresh_list)
            for k, v in counts.items():
                recall_totals[k] += v
            total_gt += gt_num

        pred_dicts = [{k: dets[k][b] for k in PRED_KEYS} for b in range(batch['batch_size'])]
        det_annos += dataset.generate_prediction_dicts(batch, pred_dicts, class_names,
                                                       output_path=out_dir)
        if logger and i % 50 == 0:
            logger.info(f'eval batch {i}/{len(loader)}')
    loop_time = time.perf_counter() - t_loop

    ret_dict = {f'recall/rcnn_{t}': recall_totals[f'recall_{t}'] / max(total_gt, 1)
                for t in thresh_list}
    if logger:
        logger.info(f'Generate label finished (predict {infer_time / max(n_frames, 1):.4f} s '
                    'a frame)')
        for t in thresh_list:
            logger.info(f"recall_rcnn_{t}: {ret_dict[f'recall/rcnn_{t}']:.4f}")

    if result_dir is not None:
        with open(result_dir / 'result.pkl', 'wb') as f:
            pickle.dump(det_annos, f)

    result_str, result_dict = dataset.evaluation(det_annos, class_names)
    if logger and result_str:
        logger.info(result_str)
    ret_dict.update(result_dict)
    ret_dict['infer_fps'] = n_frames / max(infer_time, 1e-9)
    ret_dict['loop_fps'] = n_frames / max(loop_time, 1e-9)
    return ret_dict
