from .spectral import (  # noqa: F401
    SILENTCIPHER_KEY, WatermarkConfig, apply_watermark, detect_watermark,
    init_watermarker, watermark_kind,
)
