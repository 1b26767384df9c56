"""The paper's configuration: YOLO-v3 at 512x512, split at layer l=12
(tensor 64x64x256, Q=128), C in {8..128}, n in {2..8}."""
from repro_torch.data.synthetic import ShapesDatasetConfig
from repro_torch.models.cnn import CNNConfig

PAPER_C_SWEEP = (8, 16, 32, 64, 128)
PAPER_N_SWEEP = (2, 3, 4, 5, 6, 7, 8)
PAPER_SPLIT_LAYER = 12
PAPER_TENSOR_SHAPE = (64, 64, 256)    # N x M x P at input 512x512


def full_config() -> CNNConfig:
    """Full paper geometry, 80 classes."""
    return CNNConfig(width_mult=1.0, input_size=512, num_classes=80,
                     tail_res_blocks=2)


def smoke_config() -> CNNConfig:
    """Reduced width, same topology."""
    return CNNConfig(width_mult=0.25, input_size=128, num_classes=8,
                     tail_res_blocks=1)


def smoke_data_config() -> ShapesDatasetConfig:
    return ShapesDatasetConfig(image_size=128, num_classes=8, batch_size=16)
