"""Sequential network: an ordered list of stages applied in turn
(port of nlt_tpu/networks/seq.py). `stages` is a list of
elements.Layer; params is a per-stage list, so the model can
interleave per-stage applications."""


class Network:
    def __init__(self):
        self.stages = []

    @staticmethod
    def str2none(s):
        """'None'/'none' strings in configs mean Python None."""
        if s is None:
            return None
        assert isinstance(s, str), "Call this only on strings"
        if s.lower() == "none":
            return None
        return s

    def init_params(self, gen, in_ch):
        """Returns (params_list, out_ch)."""
        params = []
        ch = in_ch
        for stage in self.stages:
            p, ch = stage.init(gen, ch)
            params.append(p)
        return params, ch

    def apply(self, params, x):
        assert len(params) == len(self.stages)
        for stage, p in zip(self.stages, params):
            x = stage.apply(p, x)
        return x

    def apply_stage(self, params, stage_i, x):
        return self.stages[stage_i].apply(params[stage_i], x)

    def __len__(self):
        return len(self.stages)
