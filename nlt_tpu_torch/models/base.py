"""Model base: the weighted losses and the static-feature cache hooks
(port of nlt_tpu/models/base.py).

Subclass contract:
    init_params(generator) -> params tree {'net': ..., 'loss': ...}
    apply(params, batch, mode, ...) -> (pred, gt, loss_kwargs, to_vis)
    compute_loss(params, pred, gt, **loss_kwargs) -> loss
"""

from .. import losses as losses_mod

ALLOWED_MODES = ("train", "vali", "test")


class Model:
    def __init__(self, config):
        self.config = config
        # [(weight, loss)] from the config's loss spec.
        self.wloss = self._init_loss()

    def _init_loss(self):
        return losses_mod.build_losses(self.config.get("loss"),
                                       config=self.config)

    @staticmethod
    def _validate_mode(mode):
        if mode not in ALLOWED_MODES:
            raise ValueError(mode)

    def init_loss_params(self):
        """Loss state (Barron latents, LPIPS weights) per loss index, as
        strings; CPU tensors."""
        return {str(i): loss.init_params()
                for i, (_, loss) in enumerate(self.wloss)}

    def compute_loss(self, params, pred, gt, gt_feats=None, loss_key=None,
                     **kwargs):
        """Weighted sum of the configured losses; loss state lives under
        params['loss']. `gt_feats`: {loss_index_str: cached features}
        for the losses whose ground-truth branch is static
        (extract_gt_feats). `loss_key`: a CPU torch.Generator handed to
        the stochastic losses (E-LPIPS) only; without one they use their
        fixed seed."""
        loss = 0.0
        for i, (weight, loss_fn) in enumerate(self.wloss):
            kw = kwargs
            if gt_feats is not None and str(i) in gt_feats:
                kw = dict(kw, gt_feats=gt_feats[str(i)])
            if loss_key is not None and getattr(loss_fn, "stochastic",
                                                False):
                kw = dict(kw, generator=loss_key)
            loss = loss + weight * loss_fn(params["loss"][str(i)], gt, pred,
                                           **kw)
        return loss

    def has_stochastic_loss(self):
        return any(getattr(l, "stochastic", False) for _, l in self.wloss)

    def feat_loss_indices(self):
        """Indices of the losses whose gt branch can be computed once and
        cached (LPIPS with per_ch=False; not E-LPIPS, whose transforms
        change the gt)."""
        return [i for i, (_, l) in enumerate(self.wloss)
                if hasattr(l, "extract_feats")
                and getattr(l, "cacheable_gt", False)
                and not getattr(l, "per_ch", False)]

    def static_products(self, batch):
        """Params-independent per-example intermediates of apply() that a
        training loop may compute once and pass back (apply(statics=...))."""
        return {}

    def extract_gt_feats(self, params, gt, **kwargs):
        """{loss_index_str: features} of the static ground truth, reused
        through compute_loss(gt_feats=...) with the same loss and
        gradients (the gt branch carries no gradient)."""
        return {str(i): self.wloss[i][1].extract_feats(
                    params["loss"][str(i)], gt, **kwargs)
                for i in self.feat_loss_indices()}
