"""Application constants (port of ``zonos_tpu/serving/constants.py``)."""

TOKENS_PER_SECOND = 86
MAX_NEW_TOKENS_CEILING = 2580  # 30 s of audio
MIN_NEW_TOKENS = 86
TEXT_TO_TOKENS_MULTIPLIER = 6.5
TOKEN_SAFETY_MARGIN = 2

DEFAULT_SEED = 420
SEED_MIN = 0
SEED_MAX = 2**31 - 1

# Single requests generate one at a time. The decode step is host-bound, so
# a second request thread only competes for the host: two at once took twice
# the time of the two served one after the other on the H100, on the default
# stream or each on its own (PERF.md §6). The JAX server allows 2.
CONCURRENCY_LIMIT = 1

# UI / API parameter ranges: (low, high, default)
PARAM_RANGES = {
    "cfg_scale": (1.01, 5.0, 2.0),
    "min_p": (0.0, 1.0, 0.1),
    "fmax": (0.0, 24000.0, 22050.0),
    "pitch_std": (0.0, 400.0, 20.0),
    "speaking_rate": (0.0, 40.0, 15.0),
    "dnsmos_ovrl": (1.0, 5.0, 4.0),
    "vqscore": (0.5, 0.8, 0.78),
}

EMOTION_NAMES = (
    "happiness", "sadness", "disgust", "fear", "surprise", "anger", "other", "neutral",
)
DEFAULT_EMOTION = (0.3077, 0.0256, 0.0256, 0.0256, 0.0256, 0.0256, 0.2564, 0.3077)

MODEL_TRANSFORMER = "Zyphra/Zonos-v0.1-transformer"
MODEL_HYBRID = "Zyphra/Zonos-v0.1-hybrid"
SUPPORTED_MODELS = (MODEL_TRANSFORMER, MODEL_HYBRID)

CONFIG_FILE = "configmodel.txt"
