"""Per-class retrieval score artifacts, the reference's `evaluate` protocol
(port of cerebra/eval/scores.py; utils/Utilities.py:28-202,
LstmDistillFromDinoV2Eval.py:383-524).

The class_scores dict (TP / classIntanceRetrival / TotalRetrival /
TotalClass / Topk / Recall / Precision per class name), macro averages of
the per-class values rounded to 2 decimals, and the `{ds}_Scores.pth`,
`{ds}_Scores.txt` (JSON) and `{ds}_.csv` dumps, byte for byte the JAX
package's for the same distances and indices. The distances come from the
port's `l2_topk` on the features' device; the dict is host bookkeeping.
Labels are taken per corpus index (the JAX package's fix of the
reference's batch-local `getLabelbyIndex`, SURVEY.md §7.5).
"""

from __future__ import annotations

import csv
import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from cerebra_torch.data.schema import LabelCatalog
from cerebra_torch.eval.retrieval import l2_topk


class NpEncoder(json.JSONEncoder):
    """utils/Utilities.py:13-21."""

    def default(self, obj):
        if isinstance(obj, np.integer):
            return int(obj)
        if isinstance(obj, np.floating):
            return float(obj)
        if isinstance(obj, np.ndarray):
            return obj.tolist()
        return super().default(obj)


def build_class_scores(
    distances: np.ndarray,  # (Nq, k) squared L2, ascending
    indices: np.ndarray,  # (Nq, k) gallery indices
    gallery_class_ids: Sequence[int],
    query_class_ids: Sequence[int],
    catalog: LabelCatalog,
    metadata: Optional[dict] = None,
) -> Dict:
    """The reference class_scores dict (LstmDistillFromDinoV2Eval.py:
    383-478), per-class Recall/Precision rounded to 2 decimals."""
    k = indices.shape[1]
    scores: Dict = {"data": {}, "metadata": metadata or {}}
    data = scores["data"]
    id2str = catalog.class_id_to_str
    for q, neigh in enumerate(indices):
        cid = int(query_class_ids[q])
        cname = id2str[cid]
        entry = data.setdefault(cname, {
            "TP": 0, "classIntanceRetrival": 0, "TotalRetrival": 0, "TotalClass": 0,
            "input_images": [], "GroundTruths": [], "Predicted": [],
            "Topk": {"labels": [], "scores": [], "images": []},
            "Recall": "", "Precision": "",
        })
        neigh_ids = [int(gallery_class_ids[j]) for j in neigh]
        neigh_names = [id2str[i] for i in neigh_ids]
        if cname in neigh_names:
            entry["TP"] += 1
            entry["classIntanceRetrival"] += sum(1 for n in neigh_ids if n == cid)
            entry["Predicted"].append(cid)
        else:
            entry["Predicted"].append(neigh_ids[0])
        entry["TotalRetrival"] += k
        entry["TotalClass"] += 1
        entry["Topk"]["labels"].append(neigh_names)
        entry["Topk"]["scores"].append([list(map(float, distances[q]))])
        entry["Topk"]["images"].append([])
        entry["input_images"].append("")
        entry["GroundTruths"].append(cid)
        entry["Recall"] = round(entry["TP"] * 100 / entry["TotalClass"], 2)
        entry["Precision"] = round(entry["classIntanceRetrival"] * 100 / entry["TotalRetrival"], 2)
    return scores


def evaluate(
    gallery_features,
    query_features,
    gallery_class_ids: Sequence[int],
    query_class_ids: Sequence[int],
    catalog: LabelCatalog,
    top_k: int = 5,
    metadata: Optional[dict] = None,
) -> Tuple[float, float, Dict]:
    """The retrieval evaluation (utils/Utilities.py:28-202): exact L2 top-k
    where the features lie, the per-class tally, macro averages →
    (Recall_Total, Precision_Total, class_scores)."""
    D, I = l2_topk(torch.as_tensor(gallery_features), torch.as_tensor(query_features), top_k)
    scores = build_class_scores(D.cpu().numpy(), I.cpu().numpy(), gallery_class_ids,
                                query_class_ids, catalog, metadata)
    recalls = [c["Recall"] for c in scores["data"].values()]
    precisions = [c["Precision"] for c in scores["data"].values()]
    return float(np.mean(recalls)), float(np.mean(precisions)), scores


def save_score_artifacts(output_dir: str, dataset_name: str, class_scores: Dict,
                         recall_total: float, precision_total: float) -> List[str]:
    """Write `{ds}_Scores.pth`, `{ds}_Scores.txt` and `{ds}_.csv`
    (LstmDistillFromDinoV2Eval.py:492-522 formats) → their paths."""
    os.makedirs(output_dir, exist_ok=True)
    pth_path = os.path.join(output_dir, f"{dataset_name}_Scores.pth")
    torch.save(class_scores, pth_path)
    txt_path = os.path.join(output_dir, f"{dataset_name}_Scores.txt")
    with open(txt_path, "w") as f:
        json.dump(class_scores, f, indent=2, cls=NpEncoder)
    csv_path = os.path.join(output_dir, f"{dataset_name}_.csv")
    with open(csv_path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["srno", "label", "imagenet_label", "Total class images",
                    "Total class image Retr", "TP", "Total Images Retr", "Recall", "Precision"])
        for cnt, (cname, cdat) in enumerate(sorted(class_scores["data"].items()), start=1):
            w.writerow([cnt, dataset_name, cname, cdat["TotalClass"], cdat["TotalRetrival"],
                        cdat["TP"], cdat["classIntanceRetrival"], cdat["Recall"],
                        cdat["Precision"]])
        w.writerow([])
        w.writerow(["", "", "", "", "", "", "", recall_total, precision_total])
    return [pth_path, txt_path, csv_path]
