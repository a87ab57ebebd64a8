"""Viewers over the ``engine.Engine`` frame loop: ``viewer`` writes a
turntable of frames, ``live_viewer`` serves the loop over HTTP. Run them as
``python -m clraytracer_tpu_torch.tools.viewer`` and
``python -m clraytracer_tpu_torch.tools.live_viewer``."""
