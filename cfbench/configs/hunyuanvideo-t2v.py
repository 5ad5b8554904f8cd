"""HunyuanVideo-T2V text-to-video: the weights the benchmark draws, the
program's runner (``HunyuanVideoPipeline.__call__`` on latents, no decode),
the reference and the operation counts of a step."""

from __future__ import annotations

import contextlib

from cfbench import flops, weights
from cfbench.reference import hunyuanvideo as reference_hv
from cfbench.reference import layout


def model(cfg: dict) -> dict:
    heads, hd = cfg["num_attention_heads"], cfg["attention_head_dim"]
    return {"dim": heads * hd, "heads": heads, "head_dim": hd, "double": cfg["num_layers"],
            "single": cfg["num_single_layers"], "refiner": cfg["num_refiner_layers"],
            "in_channels": cfg["in_channels"] * cfg["patch_size"] ** 2 * cfg["patch_size_t"],
            "text_dim": cfg["text_embed_dim"], "pooled_dim": cfg["pooled_projection_dim"],
            "mlp_ratio": int(cfg["mlp_ratio"]), "guidance": cfg["guidance_embeds"],
            "axes_dim": tuple(cfg["rope_axes_dim"]), "rope_theta": cfg["rope_theta"],
            "attend_padded_text": cfg["attend_padded_text"]}


def build(cfg: dict, seed: int, device) -> dict:
    return {"dit": weights.draw(layout.hunyuanvideo_layout(model(cfg)), weights.sub_seed(seed, "dit"), device,
                                weights.DTYPES[cfg["dtype"]])}


def _tokens(traffic):
    return ((traffic["frames"] - 1) // 4 + 1) * (traffic["height"] // 16) * (traffic["width"] // 16)


def input_shapes(cfg: dict, traffic: dict) -> dict:
    m, b, s = model(cfg), traffic["batch"], traffic["text_tokens"]
    return {"txt": ((b, s, m["text_dim"]), "normal_bf16"), "mask": ((b, s), "prefix_mask"),
            "pooled": ((b, m["pooled_dim"]), "normal_bf16"),
            "noise": ((b, _tokens(traffic), m["in_channels"]), "normal_fp32")}


class Program:
    """The timed path: one request is ``HunyuanVideoPipeline.__call__`` on
    the request's noise, ``steps`` denoising steps, latents out."""

    def __init__(self, cfg: dict, traffic: dict, params: dict, device):
        from compactfusion_tpu_torch.models.hunyuanvideo import HunyuanVideoConfig
        from compactfusion_tpu_torch.pipelines.hunyuanvideo import HunyuanVideoPipeline, HunyuanVideoPipelineConfig

        m = model(cfg)
        mcfg = HunyuanVideoConfig(dim=m["dim"], double_layers=m["double"], single_layers=m["single"],
                                  heads=m["heads"], in_channels=m["in_channels"], text_dim=m["text_dim"],
                                  pooled_dim=m["pooled_dim"], axes_dim=m["axes_dim"], mlp_ratio=m["mlp_ratio"],
                                  guidance_embeds=m["guidance"], dtype=weights.DTYPES[cfg["dtype"]],
                                  refiner_layers=m["refiner"], rope_theta=m["rope_theta"])
        self.pipe = HunyuanVideoPipeline(params["dit"], None, HunyuanVideoPipelineConfig(
            model=mcfg, num_steps=traffic["steps"], guidance_scale=traffic["guidance"], height=traffic["height"],
            width=traffic["width"], num_frames=traffic["frames"], shift=traffic["shift"]), device)
        self.steps = traffic["steps"]

    def warm_up(self, req):
        """One request: its one step is every shape the window runs."""
        self.request(req, contextlib.nullcontext)

    def request(self, req, steps_window):
        with steps_window():
            lat = self.pipe(req["txt"], req["pooled"], text_mask=req["mask"], latents=req["noise"], decode=False)
        return {"latents": lat}, {}


def reference(cfg: dict, traffic: dict, params: dict, req: dict, prec, mask_joint=None) -> dict:
    return reference_hv.generate(params["dit"], req, model(cfg), traffic, prec, mask_joint=mask_joint)


def step_flops(cfg: dict, traffic: dict) -> dict:
    return flops.mmdit_step(model(cfg), _tokens(traffic), traffic["text_tokens"], traffic["batch"],
                            context_embedder=False, refiner=model(cfg)["refiner"])
