"""The server the serving loops drive: a ``Server`` over the
configuration with the run's weights, its observation pyramid baked in
set-up, and the requests of a seeded query scene; and the comparison of
the frames it served with the reference's."""

import os

from ..reference import steps as ref_steps
from . import correct, scene as scene_mod, weights
from .registry import BENCH_DIR
from .runs import program_config


class _OneBatch:
    """A dataset of one batch (Server.precompute_obs's iterate contract)."""

    def __init__(self, batch):
        self.batch = batch

    def iterate(self, seed=0, drop_remainder=False):
        return iter([self.batch])


class Served:
    """A Server over the configuration with the run's weights and a
    pyramid baked from `bs` examples of an observation scene; the
    queries of a `cams` x `lights` test-mode scene."""

    def __init__(self, run):
        from nlt_tpu_torch.serve import Server

        cfg, mix, dev = run.cfg, run.mix, run.device
        res = cfg["uvh"]
        no_checkpoint = os.path.join(BENCH_DIR, "_cache", "no_checkpoint")
        self.server = Server(no_checkpoint, config=program_config(cfg),
                             pack=mix["pack"], fields=tuple(mix["fields"]),
                             device=dev)
        weights.into_program(self.server.state["params"],
                             weights.unet(cfg, run.seed, dev))
        run.mark("server")
        self.scene = scene_mod.Scene(run.seed, "queries", res, mix["cams"],
                                     mix["lights"], False, mix["coverage"],
                                     dev)
        self.obs = scene_mod.Scene(run.seed, "observations", res,
                                   mix["obs"]["cams"], mix["obs"]["lights"],
                                   True, mix["coverage"], dev)
        self.obs_batch = scene_mod.stack(
            [self.obs.example(j) for j in range(cfg["bs"])])
        run.mark("scene")
        self.server.precompute_obs(_OneBatch(self.obs_batch), n_obs_batches=1)
        run.mark("pyramid")
        self.bs = mix["bs"]
        run.info.update(bs=self.bs, unit="request", frames_per_unit=self.bs)

    def request(self, e):
        """The request of examples e..e+bs (consecutive lights of one
        camera): its query fields and neighbour observations."""
        out = self.scene.query(e, self.bs)
        j = e % (self.obs.n - self.bs + 1)
        out.update(nn_base=self.obs.images["base"][j:j + self.bs],
                   nn_rgb=self.obs.photo("rgb", j, self.bs),
                   nn_rgb_camspc=self.obs.photo("rgb_camspc", j, self.bs))
        return out

    def ids(self, e):
        return ["q%05d" % (e + i) for i in range(self.bs)]

    def check(self, run, requests, got):
        """frame_rms_lsb of the served frames against the reference's."""
        field = run.mix["fields"][0]
        w0 = weights.unet(run.cfg, run.seed, run.device)
        want = ref_steps.frames(run.cfg, w0, self.obs_batch, requests)
        run.numbers = {"frame_rms_lsb": correct.frame_rms_lsb(
            [g[field] for g in got], want)}
        run.outputs.update(requests=requests, program=got,
                           obs_batch=self.obs_batch)
