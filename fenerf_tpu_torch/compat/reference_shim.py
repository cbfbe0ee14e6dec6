"""Import helper for the reference repository (the port's own copy of
fenerf_tpu/compat/reference_shim.py).

The reference has stale imports (numpy.lib.type_check,
torch.functional.align_tensors) and pulls torchvision, kornia and
fid_evaluation through modules the checkpoints do not need; these shims
register stand-ins for them so that the reference's model classes load,
and so that its whole-module checkpoint pickles unpickle, on a current
torch. No reference code ships in the package.
"""
import sys
import types

import numpy as np

_REFERENCE = "/root/reference"


def import_reference_siren():
    import torch

    shim = types.ModuleType("numpy.lib.type_check")
    shim.imag = np.imag
    sys.modules.setdefault("numpy.lib.type_check", shim)
    if not hasattr(torch.functional, "align_tensors"):
        torch.functional.align_tensors = lambda *a: a
    fe = types.ModuleType("fid_evaluation")
    fe.output_images = None
    sys.modules.setdefault("fid_evaluation", fe)
    # curriculums -> generators.neural_rendering -> kornia (absent)
    kornia = types.ModuleType("kornia")
    kfilters = types.ModuleType("kornia.filters")
    kfilters.filter2D = None
    kornia.filters = kfilters
    sys.modules.setdefault("kornia", kornia)
    sys.modules.setdefault("kornia.filters", kfilters)
    # generators.util -> torchvision (absent): only the name is needed
    tv = types.ModuleType("torchvision")
    tv.transforms = types.ModuleType("torchvision.transforms")
    sys.modules.setdefault("torchvision", tv)
    sys.modules.setdefault("torchvision.transforms", tv.transforms)
    if _REFERENCE not in sys.path:
        sys.path.insert(0, _REFERENCE)
    from siren import siren as ref_siren  # noqa: PLC0415

    return ref_siren


def import_reference_discriminators():
    import_reference_siren()  # shared shims/path
    import discriminators.sgdiscriminators as ref_d  # noqa: PLC0415

    return ref_d


def import_reference_generators():
    import_reference_siren()
    from generators import generators as ref_gen  # noqa: PLC0415

    return ref_gen
