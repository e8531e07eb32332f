"""AMSGrad as optax's ``scale_by_amsgrad`` defines it (b1 0.9, b2 0.999,
eps 1e-8, eps_root 0): the maximum is taken over the bias-corrected
second moment, and the update is -lr * mu_hat / (sqrt(nu_max) + eps).
With mgm > 0 (``clip_by_global_norm``) the gradients are first scaled
to that global norm when they exceed it."""

import torch

B1, B2, EPS = 0.9, 0.999, 1e-8


class AMSGrad:
    def __init__(self, params, lr, mgm=-1.0):
        self.params = params
        self.lr = float(lr)
        self.mgm = float(mgm)
        self.t = 0
        self.state = {k: [torch.zeros_like(p) for _ in range(3)]
                      for k, p in params.items()}

    @torch.no_grad()
    def step(self, grads):
        """Update self.params (a dict of tensors) in place."""
        if self.mgm > 0:
            norm = torch.sqrt(sum((g * g).sum() for g in grads.values()))
            if norm >= self.mgm:
                grads = {k: g / norm * self.mgm for k, g in grads.items()}
        self.t += 1
        c1, c2 = 1 - B1 ** self.t, 1 - B2 ** self.t
        for k, g in grads.items():
            mu, nu, nu_max = self.state[k]
            mu.mul_(B1).add_(g, alpha=1 - B1)
            nu.mul_(B2).add_(g * g, alpha=1 - B2)
            torch.maximum(nu_max, nu / c2, out=nu_max)
            self.params[k].sub_(self.lr * (mu / c1)
                                / (torch.sqrt(nu_max) + EPS))
