"""`image_restoration_tpu_torch.infer.Restorer` over the configuration's
`network` options, with any further constructor options under
`"restorer"` (such as `quant`). The seeded weights go in as a reference
checkpoint does: saved as a `.pth` under TMPDIR (removed once built) and
loaded by `Restorer(ckpt_path=..., param_key="params")`, through
`convert/pth.load_pth`."""

import tempfile
from pathlib import Path

import numpy as np
import torch


def build(spec, params, seed, device):
    from image_restoration_tpu_torch.infer import Restorer

    cfg = spec.config
    with tempfile.TemporaryDirectory(prefix="bench_w_") as tmp:
        pth = Path(tmp) / "weights.pth"
        torch.save({"params": {k: v.cpu() for k, v in params.items()}}, pth)
        return Restorer(cfg["network"], ckpt_path=str(pth),
                        param_key="params", device=device,
                        **cfg.get("restorer", {}))


class Reference:
    """`restore_batch_u8` and `input_size` of a Restorer, computed by the
    reference module (float32 with TF32 off, or the control's dtype)."""

    def __init__(self, spec, params, device, control: bool):
        cfg = spec.config
        self.ref, self.net, self.params = spec.reference, cfg["network"], \
            params
        self.device = device
        self.dtype = getattr(torch, cfg["control"]["dtype"]) if control \
            else torch.float32
        self.input_size = (self.net["input_height"], self.net["input_width"])

    def restore_batch_u8(self, imgs: np.ndarray) -> np.ndarray:
        x = torch.from_numpy(np.ascontiguousarray(imgs)).to(self.device)
        return self.ref.restore_u8(self.params, self.net, x,
                                   dtype=self.dtype).cpu().numpy()


def reference(spec, params, seed, device, control=False):
    return Reference(spec, params, device, control)
