"""Framework-wide constants, the same values as
``multimodal_baby_tpu/core/constants.py`` (a test holds them equal). The
port keeps its own copy so that it imports nothing of the JAX package."""

# special tokens (ids are part of the data contract; do not change)
PAD_TOKEN = "<pad>"
UNK_TOKEN = "<unk>"
SOS_TOKEN = "<sos>"
EOS_TOKEN = "<eos>"
PAD_TOKEN_ID = 0
UNK_TOKEN_ID = 1
SOS_TOKEN_ID = 2
EOS_TOKEN_ID = 3
SPECIAL_TOKENS = [PAD_TOKEN, UNK_TOKEN, SOS_TOKEN, EOS_TOKEN]

# utterances are padded or truncated to this length
MAX_LEN_UTTERANCE = 25

# image contract: 224x224 RGB, ImageNet-normalized
IMAGE_H = 224
IMAGE_W = 224
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

# CLIP normalization (the CLIP baseline's preprocess,
# evaluation/clip_baseline.py)
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)

# the val loader of each split is a pair: [val-split loader, eval-trial
# loader]
N_VAL_DATALOADERS_PER_SPLIT = 2

# mesh axis names (parallel/mesh.py)
DATA_AXIS = "data"    # batch / data-parallel axis
MODEL_AXIS = "model"  # vocab-sharded token embedding and tied LM head
