"""FLUX.1-dev text-to-image: the weights the benchmark draws, the program's
runner (``FluxPipeline.__call__`` then ``.decode``), the reference and the
operation counts of a step."""

from __future__ import annotations

from cfbench import flops, weights
from cfbench.reference import flux as reference_flux
from cfbench.reference import layout
from cfbench.timing import Span


def model(cfg: dict) -> dict:
    heads, hd = cfg["num_attention_heads"], cfg["attention_head_dim"]
    return {"dim": heads * hd, "heads": heads, "head_dim": hd, "double": cfg["num_layers"],
            "single": cfg["num_single_layers"], "in_channels": cfg["in_channels"] * cfg["patch_size"] ** 2,
            "text_dim": cfg["joint_attention_dim"], "pooled_dim": cfg["pooled_projection_dim"], "mlp_ratio": 4,
            "guidance": cfg["guidance_embeds"], "axes_dim": tuple(cfg["axes_dims_rope"]), "vae": cfg["vae"]}


def build(cfg: dict, seed: int, device) -> dict:
    m, dt = model(cfg), weights.DTYPES[cfg["dtype"]]
    return {"dit": weights.draw(layout.mmdit_layout(m), weights.sub_seed(seed, "dit"), device, dt),
            "vae": weights.draw(layout.vae_decoder_layout(m["vae"]), weights.sub_seed(seed, "vae"), device, dt)}


def _tokens(traffic):
    return (traffic["height"] // 16) * (traffic["width"] // 16)


def input_shapes(cfg: dict, traffic: dict) -> dict:
    m, b = model(cfg), traffic["batch"]
    return {"txt": ((b, traffic["text_tokens"], m["text_dim"]), "normal_bf16"),
            "pooled": ((b, m["pooled_dim"]), "normal_bf16"),
            "noise": ((b, _tokens(traffic), m["in_channels"]), "normal_fp32")}


class Program:
    """The timed path: one request is ``FluxPipeline.__call__`` (the steps)
    then ``.decode``; ``steps`` denoising steps a request."""

    def __init__(self, cfg: dict, traffic: dict, params: dict, device):
        from compactfusion_tpu_torch.models.flux import FluxConfig
        from compactfusion_tpu_torch.models.vae import VAEConfig
        from compactfusion_tpu_torch.pipelines.flux import FluxPipeline, FluxPipelineConfig

        m, dt = model(cfg), weights.DTYPES[cfg["dtype"]]
        v = m["vae"]
        mcfg = FluxConfig(dim=m["dim"], double_layers=m["double"], single_layers=m["single"], heads=m["heads"],
                          in_channels=m["in_channels"], text_dim=m["text_dim"], pooled_dim=m["pooled_dim"],
                          axes_dim=m["axes_dim"], mlp_ratio=m["mlp_ratio"], guidance_embeds=m["guidance"], dtype=dt)
        vcfg = VAEConfig(latent_channels=v["latent_channels"], out_channels=v["out_channels"],
                         block_out_channels=tuple(v["block_out_channels"]), layers_per_block=v["layers_per_block"],
                         norm_num_groups=v["norm_num_groups"], scaling_factor=v["scaling_factor"],
                         shift_factor=v["shift_factor"], dtype=dt)

        def pipeline(steps):
            return FluxPipeline(params["dit"], params["vae"], FluxPipelineConfig(
                model=mcfg, vae=vcfg, num_steps=steps, guidance_scale=traffic["guidance"],
                height=traffic["height"], width=traffic["width"]), device)

        self.pipe, self.warm = pipeline(traffic["steps"]), pipeline(1)
        self.steps = traffic["steps"]
        self.device = device

    def warm_up(self, req):
        """One step and one decode at the request's shapes."""
        self.warm.decode(self.warm(req["txt"], req["pooled"], latents=req["noise"], decode=False))

    def request(self, req, steps_window):
        """-> (outputs, spans); ``steps_window`` is a context around the steps."""
        with steps_window():
            lat = self.pipe(req["txt"], req["pooled"], latents=req["noise"], decode=False)
        decode = Span(self.device)
        decode.start()
        image = self.pipe.decode(lat)
        decode.stop()
        return {"latents": lat, "image": image}, {"decode_s": decode}


def reference(cfg: dict, traffic: dict, params: dict, req: dict, prec) -> dict:
    return reference_flux.generate(params["dit"], params["vae"], req, model(cfg), traffic, prec)


def step_flops(cfg: dict, traffic: dict) -> dict:
    return flops.mmdit_step(model(cfg), _tokens(traffic), traffic["text_tokens"], traffic["batch"])
