"""Speaker and audio encoders of the port (vox_serve_tpu/encoders)."""
