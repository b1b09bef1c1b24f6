"""Training loss, PyTorch (static shapes).

Counterpart of ``vda_tpu/loss/loss.py``, the rebuild of the reference's
loss/loss.py:

  * ``trimmed_procrustes_loss``: median/MAD-robust-normalised trimmed MAE
    plus multi-scale gradient matching, alpha 0.5, 4 scales (reference
    loss.py:98-195)
  * ``temporal_gradient_matching_loss``: trimmed MAE on temporal
    differences at strides 2^k, masked where the ground-truth temporal
    gradient exceeds 5% of the frame's depth range (reference
    loss.py:198-233)
  * ``video_depth_loss``: spatial + 10x stable after a per-video scale and
    shift fit (reference loss.py:236-259)

The reference takes masked medians and trimmed sorts by boolean indexing
(dynamic shapes); as in JAX they are masked sorts at static shape here:
invalid entries are pushed to +inf and selection is index arithmetic on the
valid count.  The sorts are stable (``jnp.sort`` is): the robust median
runs over the whole image with invalid pixels zeroed, so ties at 0 are the
rule, and the order among ties decides which element the gradient reaches.
The +inf sentinels are selected away by ``torch.where``, whose backward
passes zeros, so they never reach a gradient.  ``_abs`` has JAX's
derivative at 0 (+1; ``torch.abs`` gives 0): residuals of exactly 0 are
common where values tie, and there the two would send different gradients.
"""

from __future__ import annotations

import torch

_INF = float("inf")


def _abs(x):
    """|x| with ``jnp.abs``'s derivative: +1 at 0 (and at -0.0)."""
    return torch.where(x >= 0, x, -x)


def _median_lower(values):
    """Per-row median with torch.median semantics (the lower of the two
    middles).  values: (B, M).  Returns (B,)."""
    srt = torch.sort(values, dim=-1, stable=True).values
    return srt[:, (values.shape[-1] - 1) // 2]


def normalize_prediction_robust(target, mask):
    """Median / mean-absolute-deviation normalisation (reference
    loss.py:53-71).  target, mask: (B, H, W).  Returns (normalised, (m, s)),
    the statistics detached (JAX's ``stop_gradient``)."""
    b = target.shape[0]
    flat_t = target.reshape(b, -1)
    flat_m = mask.reshape(b, -1)
    ssum = flat_m.sum(-1)
    valid = ssum > 0
    # the reference medians over the FULL image with invalid pixels zeroed
    m = torch.where(valid, _median_lower(flat_t * flat_m), 0.0)
    shifted = target - m[:, None, None]
    sq = (mask * _abs(shifted)).sum(dim=(1, 2))
    s = torch.where(valid,
                    torch.clamp(sq / torch.clamp(ssum, min=1.0), min=1e-6),
                    1.0)
    return shifted / s[:, None, None], (m.detach(), s.detach())


def compute_scale_and_shift(prediction, target, mask):
    """Batched closed-form least-squares scale and shift (reference
    loss.py:74-96).  Inputs (B, H, W); returns ((B,), (B,))."""
    a_00 = (mask * prediction * prediction).sum(dim=(1, 2))
    a_01 = (mask * prediction).sum(dim=(1, 2))
    a_11 = mask.sum(dim=(1, 2))
    b_0 = (mask * prediction * target).sum(dim=(1, 2))
    b_1 = (mask * target).sum(dim=(1, 2))
    det = a_00 * a_11 - a_01 * a_01
    nz = det != 0
    safe = torch.where(nz, det, 1.0) + 1e-6
    x_0 = torch.where(nz, (a_11 * b_0 - a_01 * b_1) / safe, 0.0)
    x_1 = torch.where(nz, (-a_01 * b_0 + a_00 * b_1) / safe, 0.0)
    return x_0, x_1


def trimmed_mae_loss(prediction, target, mask, trim: float = 0.2):
    """Trimmed MAE with batch-based reduction (reference loss.py:135-160):
    the smallest (1 - trim) share of the masked |residuals| over the whole
    batch, summed, over the mask's sum."""
    m_total = mask.sum()
    res = _abs((prediction - target) * mask).reshape(-1)
    maskf = (mask > 0).reshape(-1)
    n_valid = maskf.sum()
    sorted_res = torch.sort(torch.where(maskf, res, _INF), stable=True).values
    keep_num = torch.floor(n_valid.float() * (1.0 - trim)).to(torch.int64)
    rank = torch.arange(sorted_res.shape[0], device=res.device)
    kept = torch.where(rank < keep_num, sorted_res, 0.0)
    total = torch.where(torch.isfinite(kept), kept, 0.0).sum()
    return torch.where(m_total > 0, total / torch.clamp(m_total, min=1.0),
                       0.0)


def _gradient_loss_single(prediction, target, mask, frame_id_mask=None):
    """One-scale gradient matching (reference loss.py:28-51)."""
    m_total = mask.sum()
    diff = (prediction - target) * mask
    grad_x = _abs(diff[:, :, 1:] - diff[:, :, :-1])
    mask_x = mask[:, :, 1:] * mask[:, :, :-1]
    grad_y = _abs(diff[:, 1:, :] - diff[:, :-1, :])
    mask_y = mask[:, 1:, :] * mask[:, :-1, :]
    if frame_id_mask is not None:
        mask_x = mask_x * (frame_id_mask[:, :, 1:]
                           == frame_id_mask[:, :, :-1]).to(mask.dtype)
        mask_y = mask_y * (frame_id_mask[:, 1:, :]
                           == frame_id_mask[:, :-1, :]).to(mask.dtype)
    total = (mask_x * grad_x).sum() + (mask_y * grad_y).sum()
    return torch.where(m_total > 0, total / torch.clamp(m_total, min=1.0),
                       0.0)


def gradient_loss(prediction, target, mask, scales: int = 4,
                  num_frame_h: int = 1):
    """Multi-scale gradient loss (reference loss.py:163-195)."""
    frame_id_mask = None
    if num_frame_h > 1:
        h = mask.shape[1]
        ids = torch.arange(h, device=mask.device) // (h // num_frame_h) + 1
        frame_id_mask = ids[None, :, None].expand(mask.shape)
    total = 0.0
    for scale in range(scales):
        step = 2 ** scale
        total = total + _gradient_loss_single(
            prediction[:, ::step, ::step], target[:, ::step, ::step],
            mask[:, ::step, ::step],
            None if frame_id_mask is None
            else frame_id_mask[:, ::step, ::step])
    return total


def trimmed_procrustes_loss(prediction, target, mask, alpha: float = 0.5,
                            scales: int = 4, trim: float = 0.2,
                            num_frame_h: int = 1):
    """Spatial loss (reference loss.py:98-124).  Inputs (B, H, W)."""
    pred_n, _ = normalize_prediction_robust(prediction, mask)
    targ_n, _ = normalize_prediction_robust(target, mask)
    total = trimmed_mae_loss(pred_n, targ_n, mask, trim=trim)
    if alpha > 0:
        total = total + alpha * gradient_loss(pred_n, targ_n, mask,
                                              scales=scales,
                                              num_frame_h=num_frame_h)
    return total


def temporal_gradient_matching_loss(prediction, target, mask,
                                    trim: float = 0.2,
                                    temp_grad_scales: int = 1,
                                    temp_grad_decay: float = 0.5,
                                    diff_depth_th: float = 0.05):
    """Stable loss (reference loss.py:198-233).  Inputs (B, T, H, W)."""
    maskb = mask > 0
    min_t = torch.where(maskb, target, _INF).amin(dim=(-1, -2))
    max_t = torch.where(maskb, target, -_INF).amax(dim=(-1, -2))
    target_th = (max_t - min_t) * diff_depth_th  # (B, T)

    total, cnt = 0.0, 0
    for scale in range(temp_grad_scales):
        stride = 2 ** scale
        if stride >= prediction.shape[1]:
            continue
        p = prediction[:, ::stride]
        t = target[:, ::stride]
        m = maskb[:, ::stride]
        th = target_th[:, ::stride]
        pg = torch.diff(p, dim=1)
        tg = torch.diff(t, dim=1)
        tm = m[:, 1:] & m[:, :-1]
        tm = tm & (_abs(tg) < th[:, 1:, None, None])
        total = total + trimmed_mae_loss(
            pg.reshape(-1, *pg.shape[2:]), tg.reshape(-1, *tg.shape[2:]),
            tm.reshape(-1, *tm.shape[2:]).to(pg.dtype),
            trim=trim) * (temp_grad_decay ** scale)
        cnt += 1
    return total / max(cnt, 1)


def video_depth_loss(prediction, target, mask, alpha: float = 0.5,
                     scales: int = 4, trim: float = 0.0,
                     stable_scale: float = 10.0, group=None):
    """VideoDepthLoss (reference loss.py:236-259).

    prediction, target: (B, T, H, W); mask: (B, T, H, W) bool or {0, 1}.
    Returns a dict of spatial_loss, stable_loss and total_loss.

    ``group``: a data-parallel process group whose ranks hold slices of
    one batch (in rank order).  The loss is then the one of the whole
    batch, as JAX computes it over the global batch: the trimmed MAE keeps
    the smallest share of the masked residuals of every rank and the
    masked sums run over the whole batch.  The slices are all-gathered
    (8x518x518 fp32 is 8.6 MB a rank) and every rank computes the same
    loss; the prediction's gradient reaches this rank's entries only, so
    the ranks' parameter gradients sum to the whole batch's."""
    if group is not None:
        from vda_tpu_torch.parallel import mesh as tpm

        prediction = tpm.gather_replicated(prediction, group, 0)
        target = tpm.all_gather(target, group, 0)
        mask = tpm.all_gather(mask.to(torch.uint8), group, 0).bool() \
            if mask.dtype == torch.bool else tpm.all_gather(mask, group, 0)
    maskf = mask.to(prediction.dtype)
    b, t, h, w = prediction.shape
    spatial = trimmed_procrustes_loss(
        prediction.reshape(b * t, h, w), target.reshape(b * t, h, w),
        maskf.reshape(b * t, h, w), alpha=alpha, scales=scales, trim=trim)

    scale, shift = compute_scale_and_shift(
        prediction.reshape(b, t * h, w), target.reshape(b, t * h, w),
        maskf.reshape(b, t * h, w))
    aligned = scale[:, None, None, None] * prediction \
        + shift[:, None, None, None]
    stable = temporal_gradient_matching_loss(
        aligned, target, maskf, trim=trim, temp_grad_scales=1,
        temp_grad_decay=0.5) * stable_scale

    return {
        "spatial_loss": spatial,
        "stable_loss": stable,
        "total_loss": spatial + stable,
    }
