"""The detect data pipeline of the port: host numpy, no OpenCV needed for PNG, BMP and .npy images."""

from bsyolo_tpu_torch.data.build import DataLoader
from bsyolo_tpu_torch.data.dataset import YOLODataset, load_dataset_yaml

__all__ = ["DataLoader", "YOLODataset", "load_dataset_yaml"]
