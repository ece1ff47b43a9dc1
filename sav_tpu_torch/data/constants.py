"""Dataset normalization constants (values from reference data/constants.py:
measured over a single resize-256/center-crop-224 pass of each dataset)."""

DEFAULT_CROP_FRACTION = 0.875

IMAGENET_1K_MEAN = (0.475, 0.452, 0.398)
IMAGENET_1K_STD = (0.232, 0.228, 0.229)
IMAGENET_21K_MEAN = (0.494, 0.473, 0.415)
IMAGENET_21K_STD = (0.228, 0.224, 0.230)
