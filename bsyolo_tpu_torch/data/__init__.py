"""The data pipeline of the port (detect, segment, pose and OBB samples; folder-per-class classification data): host
numpy, no OpenCV needed for PNG, BMP, JPEG and .npy images."""

from bsyolo_tpu_torch.data.build import DataLoader
from bsyolo_tpu_torch.data.classify import ClassificationDataset, ClassifyLoader
from bsyolo_tpu_torch.data.dataset import YOLODataset, load_dataset_yaml

__all__ = ["DataLoader", "YOLODataset", "load_dataset_yaml", "ClassificationDataset", "ClassifyLoader"]
