"""Offline 3-D pose extraction from FoG videos (the mmpose stage). Port of
gaitpd/data/pose_extraction.py, which imports no JAX: the port keeps its own
copy.

reference train/data_processing/mmpose/extract_skeleton.py and
extract_skeleton_lifted.py: a resume-safe, multi-process farm running
MMPoseInferencer(pose3d='human3d') over the video folder, writing one
``<video>_3d_predictions.json`` per video, skipping videos whose output
already exists, with per-worker logs and per-video exception-and-continue.

This is an offline ingestion stage, upstream of training: mmpose and cv2
are optional dependencies imported at call time (neither is installed
with the port). The orchestration (discovery, resume, fan-out, logging) is
fully implemented and unit-testable with an injected ``infer_fn``; with
mmpose installed it behaves like the reference scripts.
"""

from __future__ import annotations

import json
import multiprocessing as mp
import os
from pathlib import Path
from typing import Callable, List, Optional

VIDEO_EXTS = (".mp4", ".avi", ".mov", ".mkv")


def check_unfinished_videos(video_folder, pred_out_dir) -> List[str]:
    """Videos lacking a _3d_predictions.json (reference
    extract_skeleton_lifted.py:48-58): the resume mechanism."""
    videos = [
        v for v in os.listdir(video_folder) if v.lower().endswith(VIDEO_EXTS)
    ]
    done = {
        os.path.splitext(f.replace("_3d_predictions", ""))[0]
        for f in os.listdir(pred_out_dir)
        if f.endswith("_3d_predictions.json")
    }
    return [v for v in videos if os.path.splitext(v)[0] not in done]


def default_infer_fn(device: str = "cuda:0", **kwargs) -> Callable:
    """Build the MMPoseInferencer-backed per-video inference function
    (reference extract_skeleton_lifted.py:61-112). Requires mmpose + cv2."""
    from mmpose.apis import MMPoseInferencer  # type: ignore

    inferencer = MMPoseInferencer(pose3d="human3d", device=device)

    def infer(video_path: str) -> list:
        results = []
        for result in inferencer(video_path, return_vis=False, **kwargs):
            results.append(result)
        return results

    return infer


def process_one_video(video_path, pred_out_dir, infer_fn, log=print) -> Path:
    video_name = os.path.splitext(os.path.basename(video_path))[0]
    out_json = Path(pred_out_dir) / f"{video_name}_3d_predictions.json"
    results = infer_fn(str(video_path))
    with open(out_json, "w") as f:
        json.dump(results, f)
    log(f"Finished {video_name}: {len(results)} frames")
    return out_json


def _worker(video_list, worker_id, video_folder, pred_out_dir, log_dir, infer_builder):
    """One worker: per-worker log file, process videos, skip failures
    (reference extract_skeleton_lifted.py:115-136)."""
    log_path = Path(log_dir) / f"worker_{worker_id}.log"
    with open(log_path, "a") as log_file:

        def log(msg):
            log_file.write(msg + "\n")
            log_file.flush()

        log(f"Started. PID: {os.getpid()}.")
        infer_fn = infer_builder()
        for video in video_list:
            try:
                process_one_video(
                    Path(video_folder) / video, pred_out_dir, infer_fn, log
                )
            except Exception as e:  # noqa: BLE001 (continue to the next video)
                log(f"Error processing {video}: {e}. Trying next video...")


def extract_all(
    video_folder,
    pred_out_dir,
    log_dir,
    num_workers: int = 6,
    infer_builder: Optional[Callable] = None,
    use_processes: bool = True,
):
    """Resume-safe fan-out over all unfinished videos (reference
    extract_skeleton_lifted.py:141-172). ``infer_builder`` defaults to the
    mmpose inferencer; tests inject a stub."""
    Path(pred_out_dir).mkdir(parents=True, exist_ok=True)
    Path(log_dir).mkdir(parents=True, exist_ok=True)
    infer_builder = infer_builder or default_infer_fn
    unfinished = check_unfinished_videos(video_folder, pred_out_dir)
    if not unfinished:
        print("All videos processed.")
        return 0
    split = [unfinished[i::num_workers] for i in range(num_workers)]
    if use_processes:
        mp.set_start_method("spawn", force=True)
        procs = []
        for wid, vids in enumerate(split):
            if not vids:
                continue
            p = mp.Process(
                target=_worker,
                args=(vids, wid, video_folder, pred_out_dir, log_dir, infer_builder),
            )
            p.start()
            procs.append(p)
        for p in procs:
            p.join()
    else:  # in-process mode (tests / single-core hosts)
        for wid, vids in enumerate(split):
            if vids:
                _worker(vids, wid, video_folder, pred_out_dir, log_dir, infer_builder)
    return len(unfinished)
