"""Card-side tools of the port: seeded synthetic inputs and models, and the
eval-step profiler (``python -m ...tools.profile_eval_step``)."""
