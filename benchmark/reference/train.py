"""MVDeTr's loss and optimizer, in plain PyTorch (the paper repo's
``trainer.py:52-66`` and ``main.py:100-115``).

- Loss: ``world_focal + world_offset_l1 + (img_focal + img_offset_l1 +
  0.1 * img_wh_l1) / N``: CenterNet's focal loss on the heatmaps (positives
  where the target is 1, negatives weighted by ``(1 - t)^4``, over the
  positive count) and masked L1 at the ground-truth cells.
- Optimizer: Adam with coupled L2 ``weight_decay``, betas (0.95, 0.999),
  the trunk (``base.*``) at ``lr * base_lr_ratio``, stepped by OneCycle
  (30% cosine warm-up from ``max_lr / 25``, cosine anneal to
  ``max_lr / 25 / 1e4``, beta1 cycled 0.95 -> 0.85).
"""

from __future__ import annotations

import torch


def focal_loss(logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    p = torch.clamp(torch.sigmoid(logits), 1e-4, 1.0 - 1e-4)
    pos = (target == 1.0).float()
    neg = (target < 1.0).float()
    pos_loss = (torch.log(p) * (1.0 - p) ** 2 * pos).sum()
    neg_loss = (torch.log(1.0 - p) * p ** 2 * (1.0 - target) ** 4 * neg).sum()
    num_pos = pos.sum()
    return torch.where(num_pos == 0, -neg_loss, -(pos_loss + neg_loss) / torch.clamp(num_pos, min=1.0))


def reg_l1_loss(output: torch.Tensor, mask: torch.Tensor, idx: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    b, h, w, c = output.shape
    pred = torch.take_along_dim(output.reshape(b, h * w, c), idx.long()[..., None], dim=1)
    m = mask.float()[..., None].expand_as(pred)
    return torch.abs(pred * m - target * m).sum() / (m.sum() + 1e-4)


def loss_terms(outputs, batch: dict) -> dict:
    (world_hm, world_off), (img_hm, img_off, img_wh) = outputs
    wgt, igt = batch["world_gt"], batch["imgs_gt"]
    b, n = igt["heatmap"].shape[:2]

    def flat(x):
        return x.reshape((b * n,) + tuple(x.shape[2:]))

    terms = {"w_hm": focal_loss(world_hm, wgt["heatmap"]),
             "w_off": reg_l1_loss(world_off, wgt["reg_mask"], wgt["idx"], wgt["offset"]),
             "img_hm": focal_loss(img_hm, flat(igt["heatmap"])),
             "img_off": reg_l1_loss(img_off, flat(igt["reg_mask"]), flat(igt["idx"]), flat(igt["offset"])),
             "img_wh": reg_l1_loss(img_wh, flat(igt["reg_mask"]), flat(igt["idx"]), flat(igt["wh"]))}
    terms["loss"] = terms["w_hm"] + terms["w_off"] + (terms["img_hm"] + terms["img_off"] + 0.1 * terms["img_wh"]) / n
    return terms


def build_optimizer(model: torch.nn.Module, cfg: dict, total_steps: int):
    lr, ratio = cfg["lr"], cfg["base_lr_ratio"]
    base = [p for name, p in model.named_parameters() if name.split(".", 1)[0] == "base"]
    other = [p for name, p in model.named_parameters() if name.split(".", 1)[0] != "base"]
    optimizer = torch.optim.Adam([{"params": base, "lr": lr * ratio}, {"params": other, "lr": lr}], lr=lr,
                                 betas=(0.95, 0.999), eps=1e-8, weight_decay=cfg["weight_decay"])
    scheduler = torch.optim.lr_scheduler.OneCycleLR(
        optimizer, max_lr=[lr * ratio, lr], total_steps=total_steps, pct_start=0.3, anneal_strategy="cos",
        cycle_momentum=True, base_momentum=0.85, max_momentum=0.95, div_factor=25.0, final_div_factor=1e4)
    return optimizer, scheduler


def device_batch(batch: dict, device) -> dict:
    def put(x):
        return {k: put(v) for k, v in x.items()} if isinstance(x, dict) else torch.as_tensor(x).to(device)

    return {k: put(v) for k, v in batch.items() if k in ("imgs", "world_gt", "imgs_gt")}


class Trainer:
    """The reference's training run on ``ref``, the configuration's
    reference module (``MVDeTr``, ``warp_coords``): ``step(batch,
    generator)`` is one forward in training mode, the loss, backward, Adam
    and OneCycle."""

    def __init__(self, ref, cfg: dict, rig: dict, weights: dict, total_steps: int, device, precision: str = "f32"):
        self.ref, self.cfg, self.rig, self.device = ref, cfg, rig, device
        self.model = self.ref.MVDeTr(cfg, rig, precision).to(device)
        self.model.load_state_dict(weights, strict=True)
        self.optimizer, self.scheduler = build_optimizer(self.model, cfg, total_steps)

    def step(self, batch: dict, generator) -> dict:
        model = self.model
        model.train()
        data = device_batch(batch, self.device)
        warp = self.ref.warp_coords(self.cfg, self.rig, batch["affine_mats"]).to(self.device)
        self.optimizer.zero_grad(set_to_none=True)
        terms = loss_terms(model(data["imgs"], warp, generator), data)
        terms["loss"].backward()
        self.optimizer.step()
        self.scheduler.step()
        return {k: v.detach() for k, v in terms.items()}
