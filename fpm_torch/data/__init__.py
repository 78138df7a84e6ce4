"""Data layer: dataset ingestion and the forward simulator."""

from .loader import LoadedDataset, load_dataset, load_dataset_rgb  # noqa: F401
from .simulate import make_test_object, simulate_images, synthetic_dataset  # noqa: F401
