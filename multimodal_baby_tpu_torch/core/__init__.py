from multimodal_baby_tpu_torch.core.constants import (
    PAD_TOKEN_ID, UNK_TOKEN_ID, SOS_TOKEN_ID, EOS_TOKEN_ID,
    MAX_LEN_UTTERANCE, IMAGE_H, IMAGE_W,
)
from multimodal_baby_tpu_torch.core.config import (
    VisionConfig, TextConfig, ModelConfig, TrainConfig, DataConfig,
    ParallelConfig, ExperimentConfig,
)
