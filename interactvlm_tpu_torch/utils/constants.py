"""Constants of the PyTorch port (a copy of what it uses from
``interactvlm_tpu/utils/constants.py`` and ``models/sam/sam.py``)."""

IGNORE_INDEX = -100
IMAGE_TOKEN_INDEX = -200
# sentinel for patch positions in spliced id space (never a real token)
PATCH_ID = -1

# SAM pixel normalization (reference build_sam.py:104-105)
PIXEL_MEAN = (123.675, 116.28, 103.53)
PIXEL_STD = (58.395, 57.12, 57.375)
