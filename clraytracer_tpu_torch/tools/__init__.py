"""Viewers over the ``engine.Engine`` frame loop: ``viewer`` writes a
turntable of frames, ``live_viewer`` serves the loop over HTTP. Profiling
tools of the differentiable step: ``profile_step`` (its top ops by their
time on the card) and ``grads_breakdown`` (its time with each leaf group
detached). Run each as ``python -m clraytracer_tpu_torch.tools.<name>``."""
