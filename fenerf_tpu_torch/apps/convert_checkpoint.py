"""Convert reference PyTorch checkpoints -> the port's .npz generators
(counterpart of fenerf_tpu/apps/convert_checkpoint.py; the same .npz).

The reference saves whole nn.Module pickles ({step}_generator.pth beside
ema.pth / ema2.pth). Unpickling them needs the reference package
importable: --reference goes on sys.path and compat/reference_shim.py
registers stand-ins for its stale imports. The EMA files are torch_ema
objects holding shadow_params in generator.parameters() order; they are
re-associated by position. Released pickles may embed the HD path's
neural-renderer heads (.neural_renderer_img / _seg); they are converted
beside the field. Conversion is a host-side layout translation
(compat/torch_import.py): no device is involved.

Usage:
  python -m fenerf_tpu_torch.apps.convert_checkpoint \
      --generator path/to/generator.pth --model auto --out generator.npz \
      [--reference path/to/reference]
"""
from __future__ import annotations

import argparse
import os
import sys


def _ema_to_params(ema_obj, torch_module):
    """torch_ema.ExponentialMovingAverage -> a state_dict-like mapping by
    parameter order (the EMA stores a flat shadow_params list); buffers
    come from the module."""
    shadow = getattr(ema_obj, "shadow_params", None)
    if shadow is None:
        return None
    names = [n for n, _ in torch_module.named_parameters()]
    assert len(names) == len(shadow), (len(names), len(shadow))
    sd = dict(torch_module.state_dict())
    for n, p in zip(names, shadow):
        sd[n] = p
    return sd


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--generator", required=True, help=".pth module pickle")
    p.add_argument("--ema", default=None,
                   help="ema .pth (default: sibling ema.pth if present)")
    p.add_argument("--ema2", default=None)
    p.add_argument("--model", default="auto",
                   help="field variant name, or 'auto' from the module class")
    p.add_argument("--out", required=True)
    p.add_argument("--reference", default="/root/reference")
    args = p.parse_args(argv)

    sys.path.insert(0, args.reference)
    import torch

    from fenerf_tpu_torch.apps.common import save_generator
    from fenerf_tpu_torch.compat import reference_shim
    from fenerf_tpu_torch.compat.torch_import import (field_from_torch,
                                                      grid_field_from_torch)
    from fenerf_tpu_torch.nn import fields
    from fenerf_tpu_torch.nn import latent_grid_field as lgf
    from fenerf_tpu_torch.nn.neural_renderer import (
        config_from_torch_module, neural_renderer_from_torch)

    reference_shim.import_reference_generators()  # register shims for pickle

    gen_module = torch.load(args.generator, map_location="cpu",
                            weights_only=False)
    siren = gen_module.siren if hasattr(gen_module, "siren") else gen_module
    model = args.model
    if model == "auto":
        model = type(siren).__name__

    if lgf.is_grid_model(model):
        # the latent-grid family (SPATIALSIRENGRID)
        field_kwargs = {
            "z_dim": getattr(siren, "z_dim", 256),
            "hidden_dim": getattr(siren, "hidden_dim", 256),
        }
        import_fn = grid_field_from_torch
    else:
        field_kwargs = {
            "z_geo_dim": getattr(siren, "z_geo_dim",
                                 getattr(siren, "z_dim", 256)),
            "z_app_dim": getattr(siren, "z_app_dim",
                                 getattr(siren, "z_dim", 256)),
            "hidden_dim": getattr(siren, "hidden_dim", 256),
        }
        fcfg = fields.get_config(model, **field_kwargs)
        if fcfg.output_dim != siren.output_dim:
            # semantic layout: 1 bg + n_labels + 3 rgb (+weight ch); HD/RGB
            # variants carry their output structure in the registry already
            field_kwargs["n_labels"] = siren.output_dim - 4
            fcfg = fields.get_config(model, **field_kwargs)
        import_fn = lambda sd: field_from_torch(sd, fcfg)
    params = import_fn(siren.state_dict())

    def load_ema(path):
        if not path or not os.path.exists(path):
            return params
        ema_obj = torch.load(path, map_location="cpu", weights_only=False)
        sd = _ema_to_params(ema_obj, gen_module)
        if sd is None:
            return params
        sd = {k[len("siren."):]: v for k, v in sd.items()
              if k.startswith("siren.")}
        return import_fn(sd)

    base = os.path.dirname(args.generator)
    ema = load_ema(args.ema or os.path.join(base, "ema.pth"))
    ema2 = load_ema(args.ema2 or os.path.join(base, "ema2.pth"))

    neural_renderers = {}
    for attr, key in (("neural_renderer_img", "nr_img"),
                      ("neural_renderer_seg", "nr_seg")):
        tm = getattr(gen_module, attr, None)
        if tm is None:
            continue
        nr_cfg = config_from_torch_module(tm)
        neural_renderers[key] = (
            neural_renderer_from_torch(tm.state_dict(), nr_cfg), nr_cfg)
    step = int(getattr(gen_module, "step", 0))
    save_generator(args.out, params, ema, ema2, model, step,
                   field_kwargs=field_kwargs,
                   neural_renderers=neural_renderers or None)
    nr = f" + {sorted(neural_renderers)}" if neural_renderers else ""
    print(f"converted {args.generator} ({model}, step {step}){nr} "
          f"-> {args.out}")


if __name__ == "__main__":
    main()
