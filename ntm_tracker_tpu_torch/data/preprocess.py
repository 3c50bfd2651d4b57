"""Offline ILSVRC2015-VID preprocessing: XML annotations -> per-object
sequence directories of `NNNNNN.txt` metadata + `NNNNNN.bin` heatmaps.

The port's own copy of ntm_tracker_tpu/data/preprocess.py (numpy only);
the records it writes are byte-identical to the JAX package's.

Same on-disk contract as the reference so datasets are interchangeable
(preprocess.py:322-334):
  <frame>.bin  float64 raw dump of the cropbox_grid^2 Gaussian heatmap
  <frame>.txt  "y1,x1,y2,x2,by1,bx1,by2,bx2,image_path,y_offset,x_offset"
               (cropbox, transformed bbox, source JPEG, center offsets)

Pipeline per object track (old_process_sequence, preprocess.py:255-350):
  first appearance -> cropbox (8/6 enlarge) + affine to unit square; the
  canonical centered box defines offset (0,0); subsequent frames pass the
  bbox_legal deform/zoom gate, are mapped through the SAME transformation,
  and record their Gaussian gt + center offsets.

The reference's newer `data_augmentation` path is dead code with an
infinite loop (preprocess.py:426-428) and is intentionally not reproduced
(SURVEY.md §7 stage 5).
"""

from __future__ import annotations

import dataclasses
import os
import xml.etree.ElementTree as ET
import multiprocessing
from typing import Dict, List

import numpy as np

from ntm_tracker_tpu_torch.config import DataConfig
from ntm_tracker_tpu_torch.data import geometry


def parse_frame(xmlfile: str) -> dict:
    """Parse one VID annotation file (preprocess.py:44-71)."""
    root = ET.parse(xmlfile).getroot()
    sizenode = root.find("size")
    size = [int(sizenode.find("width").text), int(sizenode.find("height").text)]
    objs = {}
    for objnode in root.findall("object"):
        trackid = int(objnode.find("trackid").text)
        b = objnode.find("bndbox")
        objs[trackid] = [
            int(b.find("ymin").text),
            int(b.find("xmin").text),
            int(b.find("ymax").text),
            int(b.find("xmax").text),
        ]
    return {
        "size": size,
        "objs": objs,
        "filename": root.find("filename").text,
        "seqname": os.path.basename(root.find("folder").text),
    }


def get_img_path_from_anno_path(anno_full_path: str, anno_dir: str, image_dir: str) -> str:
    rel = anno_full_path[len(anno_dir) + 1 :]
    return os.path.join(image_dir, rel[:-3] + "JPEG")


@dataclasses.dataclass
class PreprocessJob:
    annotation_dir: str
    image_dir: str
    output_dir: str
    data: DataConfig = dataclasses.field(default_factory=DataConfig)


def process_sequence(job: PreprocessJob, root: str) -> int:
    """Process one sequence directory of XML frames; returns frames written."""
    cfg = job.data
    framefiles = sorted(x for x in os.listdir(root) if x.endswith(".xml"))
    cropboxes: Dict[int, list] = {}
    init_tb: Dict[int, list] = {}
    transformations: Dict[int, np.ndarray] = {}
    written = 0

    for framefile in framefiles:
        anno_full_path = os.path.join(root, framefile)
        parsed = parse_frame(anno_full_path)
        size = parsed["size"]
        for trackid, bbox in parsed["objs"].items():
            normalbbox = geometry.normalize_bbox(size, bbox)
            gt = None
            # ints, not floats: the reference writes the first frame's
            # offsets as "0,0" (preprocess.py:295,333) and the golden
            # fixture asserts byte equality
            offsets = (0, 0)
            if trackid not in cropboxes:
                cropboxes[trackid] = geometry.calculate_cropbox(
                    normalbbox, cfg.cropbox_grid, cfg.bbox_grid
                )
                transformations[trackid] = geometry.calculate_transformation(
                    cropboxes[trackid]
                )
                transformed_bbox = geometry.initial_transformed_bbox(
                    cfg.cropbox_grid, cfg.bbox_grid
                )
                init_tb[trackid] = transformed_bbox
                # first frame uses the configured focus (preprocess.py:291-292)
                gt = geometry.generate_gt(
                    transformed_bbox, cfg.cropbox_grid, cfg.bbox_grid, cfg.focus
                )
            else:
                if geometry.bbox_legal(
                    normalbbox, cropboxes[trackid], cfg.cropbox_grid,
                    cfg.bbox_grid, cfg.deform_threshold, cfg.zoom_threshold,
                ):
                    transformed_bbox = geometry.apply_transformation(
                        normalbbox, transformations[trackid]
                    )
                    # later frames use the default focus=3 (preprocess.py:308)
                    gt = geometry.generate_gt(
                        transformed_bbox, cfg.cropbox_grid, cfg.bbox_grid
                    )
                    offsets = geometry.calculate_offsets(
                        transformed_bbox, init_tb[trackid]
                    )
            if gt is not None:
                unique_id = parsed["seqname"] + "_" + str(trackid)
                output_dir = os.path.join(job.output_dir, unique_id)
                os.makedirs(output_dir, exist_ok=True)
                assert gt.dtype == np.float64
                gt.tofile(os.path.join(output_dir, parsed["filename"] + ".bin"))
                image_full_path = get_img_path_from_anno_path(
                    anno_full_path, job.annotation_dir, job.image_dir
                )
                crop = cropboxes[trackid]
                with open(
                    os.path.join(output_dir, parsed["filename"] + ".txt"), "w"
                ) as f:
                    f.write(
                        "{},{},{},{},{},{},{},{},{},{},{}".format(
                            crop[0], crop[1], crop[2], crop[3],
                            transformed_bbox[0], transformed_bbox[1],
                            transformed_bbox[2], transformed_bbox[3],
                            image_full_path, offsets[0], offsets[1],
                        )
                    )
                written += 1
    return written


def find_sequence_dirs(annotation_dir: str) -> List[str]:
    """Leaf directories containing .xml frames (preprocess.py:500-506)."""
    out = []
    for dirpath, dirnames, filenames in os.walk(annotation_dir):
        if any(f.endswith(".xml") for f in filenames):
            out.append(dirpath)
    return sorted(out)


def run_preprocess(job: PreprocessJob, num_workers: int = 7,
                   limit: int = 0) -> int:
    """Walk the annotation tree and process sequences in parallel, in
    spawned worker processes (preprocess.py:476-509: Pool(7); a forked
    child of a process with threads, as torch's, may hang). limit>0 keeps only the first N
    sequence dirs — the dress-rehearsal mode for real-data bring-up
    (MIGRATION.md runbook)."""
    seqs = find_sequence_dirs(job.annotation_dir)
    if limit > 0:
        seqs = seqs[:limit]
    if num_workers <= 1:
        return sum(process_sequence(job, s) for s in seqs)
    with multiprocessing.get_context("spawn").Pool(num_workers) as pool:
        counts = pool.starmap(process_sequence, [(job, s) for s in seqs], chunksize=16)
    return sum(counts)


def read_frame_record(path_noext: str, gt_width: int = 8) -> dict:
    """Read one frame's .txt/.bin pair (the loader-side contract,
    direct_offset_output.py:180-216)."""
    with open(path_noext + ".txt") as f:
        parts = f.read().strip().split(",")
    cropbox = [float(v) for v in parts[0:4]]
    bbox = [float(v) for v in parts[4:8]]
    img_path = parts[8]
    y_offset, x_offset = float(parts[9]), float(parts[10])
    gt = np.fromfile(path_noext + ".bin", dtype=np.float64).reshape(gt_width, gt_width)
    return {
        "cropbox": cropbox,
        "bbox": bbox,
        "image_path": img_path,
        "y_offset": y_offset,
        "x_offset": x_offset,
        # read as float32 downstream (direct_offset_output.py:215)
        "gt": gt.astype(np.float32),
    }
