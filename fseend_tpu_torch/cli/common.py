"""What the entry points share: the `--device` flag, the feature config
and the validation dataset of a yaml config."""

from __future__ import annotations

import argparse

from fseend_tpu_torch.data.dataset import DiarizationDataset, FeatureConfig


def add_device_arg(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--device", default="cuda",
                        help="torch device to run on (default cuda: the card; "
                             "cpu for a run without one)")


def feature_config(data: dict) -> FeatureConfig:
    return FeatureConfig(
        frame_size=data["feat"]["win_length"], frame_shift=data["feat"]["hop_length"],
        context_size=data["context_recp"], subsampling=data["subsampling"],
        rate=data["feat"]["sample_rate"], input_transform=data["feat_type"])


def val_dataset(data: dict, feat: FeatureConfig) -> DiarizationDataset:
    """The config's validation directory in `chunk_size` chunks, as the
    scoring entry points read it."""
    return DiarizationDataset(
        data["val_data_dir"], feat, chunk_size=data["chunk_size"],
        use_last_samples=data.get("use_last_samples", True),
        n_speakers=data.get("num_speakers"))


def seed_of(configs: dict, default: int) -> int:
    return int((configs.get("training") or {}).get("seed", default))
