"""Request constants (the part of ``zonos_tpu/serving/constants.py`` that the port's pipeline uses)."""

MAX_NEW_TOKENS_CEILING = 2580  # 30 s of audio
MIN_NEW_TOKENS = 86
TEXT_TO_TOKENS_MULTIPLIER = 6.5
TOKEN_SAFETY_MARGIN = 2

DEFAULT_SEED = 420
SEED_MIN = 0
SEED_MAX = 2**31 - 1

DEFAULT_EMOTION = (0.3077, 0.0256, 0.0256, 0.0256, 0.0256, 0.0256, 0.2564, 0.3077)

MODEL_TRANSFORMER = "Zyphra/Zonos-v0.1-transformer"
