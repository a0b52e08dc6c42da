from .vit import VisionTransformer
from .pe import PerceptionEncoder, preprocess_images, IMAGE_MEAN, IMAGE_STD
from .convert import convert_vision_tower, flax_params_from_vision, vision_params_from_flax
