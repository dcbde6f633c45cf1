"""Dataset-acquisition CLI: one entry point with subcommands replacing the
reference's numbered pipeline scripts (dataset/acquisition/*).

Port of playableenvironments_tpu/cli/acquire.py, with its subcommands and
flags:

    python -m playableenvironments_tpu_torch.cli.acquire <subcommand> ...

  minecraft   ReplayMod recording -> dataset splits
              (splitted_recording.py + acquire_replays.py)
  tennis      local video + sequence-annotation YAML -> frame trees
              (extract_sequences_from_youtube_1.py + extract_frames_4.py)
  calibrate   court-keypoint camera calibration for a frame tree
              (compute_camera_poses_2.py + dataset/calibration/tennis)
  boxes       detector-based player boxes (compute_bounding_boxes_3.py)
  split       train/val/test directory split (make_train_val_test_split_6.py)
  fragment    fixed-length video fragmenting (make_fixed_length_8.py)

Video download (download_youtube_videos_0.py) is intentionally out of scope:
it drives an external youtube-dl binary; any local video file works as input.

`boxes` restores a detector checkpoint of cli.train_detector and runs the
detector on `--device`, the card by default (without one it raises unless
`--device cpu`); the other subcommands are host NumPy and touch no device.
`main()` returns what the subcommand wrote: the split or sequence
directories, the calibration (rotation, translation, focal, reprojection
error), the frames annotated, the split assignment or the fragment count.
"""

from __future__ import annotations

import argparse


def _minecraft(args):
    from playableenvironments_tpu_torch.acquisition.replay_parser import ReplayRecording

    recording = ReplayRecording(
        args.annotations, args.splits, video_file=args.video,
        framerate=args.framerate,
    )
    written = recording.export(
        args.output, begin_index=args.begin_index,
        extract_frames=args.video is not None,
    )
    print(f"wrote {len(written)} splits under {args.output}")
    return written


def _tennis(args):
    from playableenvironments_tpu_torch.acquisition.tennis_ingest import (
        ingest_tennis_video,
        sequences_for_video,
    )

    sequences = sequences_for_video(
        args.annotations, args.video, args.splits_duration,
        video_name=args.video_name,
    )
    written = ingest_tennis_video(
        args.video, sequences, args.output,
        begin_index=args.begin_index, objects_count=args.objects_count,
    )
    print(f"wrote {len(written)} sequences under {args.output}")
    return written


def _calibrate(args):
    import pickle

    import numpy as np

    from playableenvironments_tpu_torch.acquisition.field_calibration import (
        calibrate_camera,
        reprojection_error,
    )
    from playableenvironments_tpu_torch.acquisition.tennis_court import court_keypoints
    from playableenvironments_tpu_torch.data.video import PoseParametersNumpy, Video

    with open(args.image_points) as f:
        image_points = np.asarray(
            [[float(v) for v in line.split()] for line in f if line.strip()]
        )
    world = court_keypoints()
    rotation, translation, focal = calibrate_camera(
        world, image_points, (args.width, args.height)
    )
    error = reprojection_error(
        world, image_points, (args.width, args.height), rotation, translation,
        focal,
    )
    print(f"rotation={rotation} translation={translation} "
          f"focal={focal:.2f} reprojection={error:.3f}px")
    if error > args.max_error:
        raise SystemExit(f"reprojection error {error:.2f}px > {args.max_error}")
    if args.camera_dir:
        video = Video().load(args.camera_dir)
        pose = PoseParametersNumpy(
            rotation=list(map(float, rotation)),
            translation=list(map(float, translation)),
        )
        video.cameras = [pose] * video.frames_count
        video.focals = [focal] * video.frames_count
        video.save_annotations(args.camera_dir)
        print(f"camera annotations written to {args.camera_dir}")
    return rotation, translation, focal, error


def _boxes(args):
    from playableenvironments_tpu_torch.acquisition.boxes import (
        annotate_dataset_boxes,
        detector_boxes_fn,
    )
    from playableenvironments_tpu_torch.train import checkpointing
    from playableenvironments_tpu_torch.train.trainer_detector import (
        DetectorTrainer,
        DetectorTrainingConfig,
    )
    from playableenvironments_tpu_torch.utils.device import resolve_device

    trainer = DetectorTrainer(
        DetectorTrainingConfig(base_features=args.base_features),
        device=resolve_device(args.device),
    )
    trainer = checkpointing.restore_checkpoint(args.detector_checkpoint, trainer)
    detector = detector_boxes_fn(
        trainer, top_k=max(args.objects_count * 2, 4),
        threshold=args.threshold,
    )
    frames = annotate_dataset_boxes(args.root, detector, args.objects_count)
    print(f"annotated {frames} frames under {args.root}")
    return frames


def _split(args):
    from playableenvironments_tpu_torch.acquisition.splits import split_dataset

    assignment = split_dataset(
        args.root, args.output,
        fractions=(args.train, args.val, 1.0 - args.train - args.val),
        move=args.move,
    )
    for split, names in assignment.items():
        print(f"{split}: {len(names)} videos")
    return assignment


def _fragment(args):
    from playableenvironments_tpu_torch.acquisition.splits import make_fixed_length

    count = make_fixed_length(args.root, args.output, args.length)
    print(f"wrote {count} fragments of {args.length} frames to {args.output}")
    return count


def main():
    parser = argparse.ArgumentParser(description="Dataset acquisition")
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("minecraft", help="ingest a ReplayMod recording")
    p.add_argument("--annotations", required=True)
    p.add_argument("--splits", required=True)
    p.add_argument("--video", default=None)
    p.add_argument("--framerate", type=int, default=None)
    p.add_argument("--output", required=True)
    p.add_argument("--begin_index", type=int, default=0)
    p.set_defaults(func=_minecraft)

    p = sub.add_parser("tennis", help="ingest an annotated tennis video")
    p.add_argument("--video", required=True, help="local video file")
    p.add_argument("--annotations", required=True,
                   help="sequence-annotation YAML (reference format)")
    p.add_argument("--splits_duration", type=float, default=600.0,
                   help="duration in seconds of the annotation video splits")
    p.add_argument("--video_name", default=None,
                   help="annotation key (defaults to the video's basename)")
    p.add_argument("--output", required=True)
    p.add_argument("--begin_index", type=int, default=0)
    p.add_argument("--objects_count", type=int, default=2)
    p.set_defaults(func=_tennis)

    p = sub.add_parser("calibrate", help="planar-court camera calibration")
    p.add_argument("--image_points", required=True,
                   help="text file: one 'x y' pixel pair per court keypoint")
    p.add_argument("--width", type=int, required=True)
    p.add_argument("--height", type=int, required=True)
    p.add_argument("--max_error", type=float, default=10.0)
    p.add_argument("--camera_dir", default=None,
                   help="camera directory to write camera annotations into")
    p.set_defaults(func=_calibrate)

    p = sub.add_parser("boxes", help="detector-based player boxes")
    p.add_argument("--root", required=True)
    p.add_argument("--detector_checkpoint", required=True)
    p.add_argument("--objects_count", type=int, default=2)
    p.add_argument("--threshold", type=float, default=0.3)
    p.add_argument("--base_features", type=int, default=32)
    p.add_argument("--device", default="cuda",
                   help="the detector's device (cuda, or cpu for the plain versions)")
    p.set_defaults(func=_boxes)

    p = sub.add_parser("split", help="train/val/test split")
    p.add_argument("--root", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--train", type=float, default=0.8)
    p.add_argument("--val", type=float, default=0.1)
    p.add_argument("--move", action="store_true")
    p.set_defaults(func=_split)

    p = sub.add_parser("fragment", help="fixed-length fragmenting")
    p.add_argument("--root", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--length", type=int, required=True)
    p.set_defaults(func=_fragment)

    args = parser.parse_args()
    return args.func(args)


if __name__ == "__main__":
    main()
