"""Tools of the port: tiled whole-slide inference, the ``snet-predict`` CLI,
the ``snet-serve`` HTTP server, stitched whole-slide scoring (``snet-wsi``),
selection-threshold calibration (``snet-calibrate``), MC-dropout
uncertainty, fold lists (``snet-split``), the experiment grid
(``snet-sweep``), checkpoint inspection (``snet-inspect-ckpt``), the
``torch.export`` serving artifact (``snet-export``) (JAX counterparts:
``tools/``), seeded synthetic inputs, models and patch trees, and the eval-
and train-step profilers.

Lazy re-exports, as in the JAX package: importing the package imports no
tool. ``calibrate`` and ``tiled_inference`` always name the submodules
(their functions of the same name would be shadowed by them)."""

_EXPORTS = {
    "make_heatmap": ".wsi",
    "save_performance_as_csv": ".wsi",
    "stitch_patches": ".wsi",
    "wsi_inference": ".wsi",
    "mc_uncertainty": ".uncertainty",
    "risk_coverage_curve": ".calibrate",
    "threshold_for_coverage": ".calibrate",
    "predict_image": ".predict",
    "PredictionService": ".serve",
    "make_server": ".serve",
    "wsi_mask": ".tiled_inference",
    "build_fold_lists": ".data_split",
    "mine_non_tissue": ".data_split",
    "tumor_pixel_report": ".data_split",
    "tumor_proportion_histogram": ".data_split",
    "run_sweep": ".sweep",
    "Variant": ".sweep",
    "default_grid": ".sweep",
    "export_serving": ".export",
    "make_serving_fn": ".export",
}

_SUBMODULES = frozenset({
    "calibrate", "data_split", "export", "inspect_ckpt", "predict", "profile_eval_step",
    "profile_train_step", "serve", "sweep", "synthetic", "tiled_inference", "uncertainty",
    "wsi",
})

__all__ = sorted(set(_EXPORTS) | _SUBMODULES)


def __getattr__(name):
    from importlib import import_module

    if name in _SUBMODULES:
        return import_module("." + name, __name__)
    try:
        module = _EXPORTS[name]
    except KeyError:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}") from None
    value = getattr(import_module(module, __name__), name)
    globals()[name] = value
    return value


def __dir__():
    return __all__
