"""COCO-style mAP evaluation (bbox and segm).

Port of ``feature_intertwiner_tpu/evaluation/cocoeval.py``, the standard
COCO protocol as ``pycocotools.cocoeval`` runs it: greedy score-descending
matching per (image, category) at IoU thresholds 0.5:0.05:0.95, crowd and
ignore handling, area ranges all/small/medium/large, maxDets 1, 10 and 100,
101-point interpolated precision; ``summarize(log_file)`` prints the 12
stats and appends them to a file.
"""

from __future__ import annotations

import datetime
import time
from collections import defaultdict
from typing import List, Optional

import numpy as np

from .rle import RLE, bbox_iou_matrix


class Params:
    def __init__(self, iou_type: str = "bbox"):
        self.iou_type = iou_type
        self.img_ids: List[int] = []
        self.cat_ids: List[int] = []
        self.iou_thrs = np.linspace(0.5, 0.95, 10)
        self.rec_thrs = np.linspace(0.0, 1.0, 101)
        self.max_dets = [1, 10, 100]
        self.area_rng = [[0, 1e10], [0, 32 ** 2], [32 ** 2, 96 ** 2],
                         [96 ** 2, 1e10]]
        self.area_lbl = ["all", "small", "medium", "large"]
        self.use_cats = True


class COCOeval:
    def __init__(self, coco_gt, coco_dt, iou_type: str = "bbox"):
        self.coco_gt = coco_gt
        self.coco_dt = coco_dt
        self.params = Params(iou_type)
        self.params.img_ids = sorted(coco_gt.imgs.keys())
        self.params.cat_ids = sorted(coco_gt.cats.keys())
        self.stats = np.zeros(12)
        self._ious = {}
        self._img_cat_eval = {}
        self.eval: dict = {}

    # ------------------------------------------------------------------
    def _load_anns(self):
        p = self.params
        gts = defaultdict(list)
        dts = defaultdict(list)
        # use_cats=False: category-agnostic evaluation — every annotation
        # keys to the single pseudo-category -1 (pycocotools useCats=0)
        cat_of = ((lambda a: a["category_id"]) if p.use_cats
                  else (lambda a: -1))
        for ann in self.coco_gt.anns.values():
            gts[(ann["image_id"], cat_of(ann))].append(ann)
        for ann in self.coco_dt.anns.values():
            dts[(ann["image_id"], cat_of(ann))].append(ann)
        self._gts, self._dts = gts, dts

    def _compute_iou(self, img_id: int, cat_id: int) -> np.ndarray:
        gts = self._gts.get((img_id, cat_id), [])
        dts = sorted(self._dts.get((img_id, cat_id), []),
                     key=lambda d: -d["score"])[: self.params.max_dets[-1]]
        if not gts or not dts:
            return np.zeros((len(dts), len(gts)))
        iscrowd = np.array([g.get("iscrowd", 0) for g in gts], np.uint8)
        if self.params.iou_type == "bbox":
            d = np.array([dt["bbox"] for dt in dts])
            g = np.array([gt["bbox"] for gt in gts])
            return bbox_iou_matrix(d, g, iscrowd)
        # segm
        img = self.coco_gt.imgs[img_id]
        h, w = img["height"], img["width"]
        drles = [RLE.from_coco(dt["segmentation"], h, w) for dt in dts]
        grles = [RLE.from_coco(gt["segmentation"], h, w) for gt in gts]
        out = np.zeros((len(drles), len(grles)))
        for i, dr in enumerate(drles):
            for j, gr in enumerate(grles):
                out[i, j] = dr.iou(gr, iscrowd=bool(iscrowd[j]))
        return out

    def _evaluate_img(self, img_id, cat_id, area_rng, max_det):
        gts = self._gts.get((img_id, cat_id), [])
        dts = sorted(self._dts.get((img_id, cat_id), []),
                     key=lambda d: -d["score"])[:max_det]
        if not gts and not dts:
            return None
        t = len(self.params.iou_thrs)

        g_ignore = np.array([
            g.get("iscrowd", 0) == 1 or g.get("ignore", 0) == 1
            or not (area_rng[0] <= g.get("area", 0) <= area_rng[1])
            for g in gts], bool)
        # sort gts: unignored first (stable)
        g_order = np.argsort(g_ignore, kind="stable")
        ious = self._ious[(img_id, cat_id)]
        ious = ious[:len(dts), :][:, g_order] if ious.size else ious
        g_ignore = g_ignore[g_order]
        crowd = np.array([gts[i].get("iscrowd", 0) for i in g_order], bool)

        gm = np.zeros((t, len(gts)), np.int64) - 1       # matched dt index
        dm = np.zeros((t, len(dts)), np.int64) - 1       # matched gt index
        d_ignore = np.zeros((t, len(dts)), bool)

        # Greedy matching vectorized over IoU thresholds: per detection (in
        # score order) each threshold row independently picks the best
        # available gt — unignored gts preferred, max IoU wins, ties to the
        # later gt (the reference loop's >= update).
        if len(gts):
            thrs = np.minimum(self.params.iou_thrs, 1 - 1e-10)[:, None]  # [T,1]
            g = len(gts)
            t_idx = np.arange(t)

            def last_argmax(values, mask):
                """per-row argmax over masked values, ties -> last index."""
                masked = np.where(mask, values, -np.inf)
                rev = masked[:, ::-1]
                idx = g - 1 - np.argmax(rev, axis=1)
                ok = np.isfinite(np.max(masked, axis=1))
                return idx, ok

            for di in range(len(dts)):
                iou_row = ious[di][None, :]                      # [1, G]
                avail = (gm < 0) | crowd[None, :]
                above = iou_row >= thrs
                cand_un = avail & above & ~g_ignore[None, :]
                cand_ig = avail & above & g_ignore[None, :]
                idx_un, ok_un = last_argmax(np.broadcast_to(iou_row, (t, g)),
                                            cand_un)
                idx_ig, ok_ig = last_argmax(np.broadcast_to(iou_row, (t, g)),
                                            cand_ig)
                match = np.where(ok_un, idx_un, np.where(ok_ig, idx_ig, -1))
                matched = match >= 0
                dm[matched, di] = match[matched]
                gm[t_idx[matched], match[matched]] = di
                d_ignore[matched, di] = g_ignore[match[matched]]

        # unmatched dts outside the area range are ignored
        d_area_ignore = np.array([
            not (area_rng[0] <= d["bbox"][2] * d["bbox"][3] <= area_rng[1])
            for d in dts], bool) if self.params.iou_type == "bbox" else \
            np.array([not (area_rng[0] <= d.get("area",
                     d["bbox"][2] * d["bbox"][3]) <= area_rng[1])
                      for d in dts], bool)
        d_ignore = d_ignore | ((dm == -1) & d_area_ignore[None, :])

        return {
            "scores": np.array([d["score"] for d in dts]),
            "dt_matches": dm,
            "dt_ignore": d_ignore,
            "gt_ignore": g_ignore,
            "num_gt": int((~g_ignore).sum()),
        }

    # ------------------------------------------------------------------
    def evaluate(self):
        t0 = time.time()
        self._load_anns()
        p = self.params
        cat_list = p.cat_ids if p.use_cats else [-1]
        for img_id in p.img_ids:
            for cat_id in cat_list:
                self._ious[(img_id, cat_id)] = self._compute_iou(img_id, cat_id)
        self._evals = {}
        for ai, area_rng in enumerate(p.area_rng):
            for img_id in p.img_ids:
                for cat_id in cat_list:
                    self._evals[(img_id, cat_id, ai)] = self._evaluate_img(
                        img_id, cat_id, area_rng, p.max_dets[-1])
        print(f"COCOeval evaluate done in {time.time() - t0:.2f}s")

    def accumulate(self):
        p = self.params
        cat_list = p.cat_ids if p.use_cats else [-1]
        t, r = len(p.iou_thrs), len(p.rec_thrs)
        k, a, m = len(cat_list), len(p.area_rng), len(p.max_dets)
        precision = -np.ones((t, r, k, a, m))
        recall = -np.ones((t, k, a, m))
        scores_out = -np.ones((t, r, k, a, m))

        for ki, cat_id in enumerate(cat_list):
            for ai in range(a):
                evals = [self._evals.get((img_id, cat_id, ai))
                         for img_id in p.img_ids]
                evals = [e for e in evals if e is not None]
                if not evals:
                    continue
                num_gt = sum(e["num_gt"] for e in evals)
                for mi, max_det in enumerate(p.max_dets):
                    scores = np.concatenate(
                        [e["scores"][:max_det] for e in evals])
                    order = np.argsort(-scores, kind="mergesort")
                    scores_sorted = scores[order]
                    dm = np.concatenate(
                        [e["dt_matches"][:, :max_det] for e in evals],
                        axis=1)[:, order]
                    dig = np.concatenate(
                        [e["dt_ignore"][:, :max_det] for e in evals],
                        axis=1)[:, order]
                    tps = (dm >= 0) & ~dig
                    fps = (dm == -1) & ~dig
                    tp_cum = np.cumsum(tps, axis=1).astype(float)
                    fp_cum = np.cumsum(fps, axis=1).astype(float)
                    if num_gt == 0:
                        continue
                    for ti in range(t):
                        tp, fp = tp_cum[ti], fp_cum[ti]
                        rc = tp / num_gt
                        pr = tp / np.maximum(tp + fp, np.finfo(float).eps)
                        recall[ti, ki, ai, mi] = rc[-1] if len(rc) else 0
                        # precision envelope (monotone decreasing)
                        pr = pr.tolist()
                        for i in range(len(pr) - 1, 0, -1):
                            pr[i - 1] = max(pr[i - 1], pr[i])
                        idx = np.searchsorted(rc, p.rec_thrs, side="left")
                        q = np.zeros(r)
                        s = np.zeros(r)
                        for ri, pi in enumerate(idx):
                            if pi < len(pr):
                                q[ri] = pr[pi]
                                s[ri] = scores_sorted[pi]
                        precision[ti, :, ki, ai, mi] = q
                        scores_out[ti, :, ki, ai, mi] = s

        self.eval = {
            "precision": precision,
            "recall": recall,
            "scores": scores_out,
            "counts": [t, r, k, a, m],
            "date": datetime.datetime.now().strftime("%Y-%m-%d %H:%M:%S"),
        }

    # ------------------------------------------------------------------
    def _summarize_one(self, ap=1, iou_thr=None, area="all", max_dets=100):
        p = self.params
        ai = p.area_lbl.index(area)
        mi = p.max_dets.index(max_dets)
        if ap:
            s = self.eval["precision"]
            if iou_thr is not None:
                ti = np.where(np.isclose(p.iou_thrs, iou_thr))[0]
                s = s[ti]
            s = s[:, :, :, ai, mi]
        else:
            s = self.eval["recall"]
            if iou_thr is not None:
                ti = np.where(np.isclose(p.iou_thrs, iou_thr))[0]
                s = s[ti]
            s = s[:, :, ai, mi]
        valid = s[s > -1]
        return float(np.mean(valid)) if valid.size else -1.0

    def summarize(self, log_file: Optional[str] = None):
        """The 12-stat summary; tees to ``log_file`` like the reference's
        patched summarize (cocoeval.py:420)."""
        defs = [
            (1, None, "all", 100, "Average Precision  (AP) @[ IoU=0.50:0.95 | area=   all | maxDets=100 ]"),
            (1, 0.5, "all", 100,  "Average Precision  (AP) @[ IoU=0.50      | area=   all | maxDets=100 ]"),
            (1, 0.75, "all", 100, "Average Precision  (AP) @[ IoU=0.75      | area=   all | maxDets=100 ]"),
            (1, None, "small", 100, "Average Precision  (AP) @[ IoU=0.50:0.95 | area= small | maxDets=100 ]"),
            (1, None, "medium", 100, "Average Precision  (AP) @[ IoU=0.50:0.95 | area=medium | maxDets=100 ]"),
            (1, None, "large", 100, "Average Precision  (AP) @[ IoU=0.50:0.95 | area= large | maxDets=100 ]"),
            (0, None, "all", 1, "Average Recall     (AR) @[ IoU=0.50:0.95 | area=   all | maxDets=  1 ]"),
            (0, None, "all", 10, "Average Recall     (AR) @[ IoU=0.50:0.95 | area=   all | maxDets= 10 ]"),
            (0, None, "all", 100, "Average Recall     (AR) @[ IoU=0.50:0.95 | area=   all | maxDets=100 ]"),
            (0, None, "small", 100, "Average Recall     (AR) @[ IoU=0.50:0.95 | area= small | maxDets=100 ]"),
            (0, None, "medium", 100, "Average Recall     (AR) @[ IoU=0.50:0.95 | area=medium | maxDets=100 ]"),
            (0, None, "large", 100, "Average Recall     (AR) @[ IoU=0.50:0.95 | area= large | maxDets=100 ]"),
        ]
        lines = []
        for i, (ap, thr, area, md, label) in enumerate(defs):
            self.stats[i] = self._summarize_one(ap, thr, area, md)
            lines.append(f" {label} = {self.stats[i]:0.3f}")
        text = "\n".join(lines)
        print(text)
        if log_file:
            with open(log_file, "a") as f:
                f.write(text + "\n")
        return self.stats
