"""Tools of the port: tiled whole-slide inference, the ``snet-predict`` CLI
and the ``snet-serve`` HTTP server (JAX counterparts: ``tools/``), seeded
synthetic inputs and models, and the eval- and train-step profilers."""
