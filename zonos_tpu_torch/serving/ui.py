"""Optional Gradio UI and the control list of ``/ui_spec`` (port of
``zonos_tpu/serving/ui.py``).

``control_specs`` is what the server's web UI renders. ``build_ui`` needs
gradio and raises a clear ImportError without it; the HTTP server
(serving/server.py) is the dependency-free surface.
"""

from __future__ import annotations

from zonos_tpu_torch.serving import constants as C


def control_specs(conditioner_names: list[str]) -> list[dict]:
    """Declarative UI control list: (name, kind, range, visible).

    Visibility follows the loaded model's conditioners.
    """
    from zonos_tpu_torch.conditioning.cond_dict import supported_language_codes

    has = set(conditioner_names)
    lo_hi = C.PARAM_RANGES
    specs = [
        {"name": "text", "kind": "textbox", "visible": True},
        {"name": "language", "kind": "dropdown", "visible": "espeak" in has,
         "choices": list(supported_language_codes), "default": "en-us"},
        {"name": "speaker_audio", "kind": "audio", "visible": "speaker" in has},
        {"name": "prefix_audio", "kind": "audio", "visible": True},
        {"name": "cfg_scale", "kind": "slider", "range": lo_hi["cfg_scale"], "visible": True},
        {"name": "min_p", "kind": "slider", "range": lo_hi["min_p"], "visible": True},
        {"name": "fmax", "kind": "slider", "range": lo_hi["fmax"], "visible": "fmax" in has},
        {"name": "pitch_std", "kind": "slider", "range": lo_hi["pitch_std"], "visible": "pitch_std" in has},
        {"name": "speaking_rate", "kind": "slider", "range": lo_hi["speaking_rate"], "visible": "speaking_rate" in has},
        {"name": "dnsmos_ovrl", "kind": "slider", "range": lo_hi["dnsmos_ovrl"], "visible": "dnsmos_ovrl" in has},
        {"name": "vqscore_8", "kind": "slider", "range": lo_hi["vqscore"], "visible": "vqscore_8" in has},
        {"name": "speaker_noised", "kind": "checkbox", "visible": "speaker_noised" in has},
        {"name": "seed", "kind": "number", "visible": True},
        {"name": "randomize_seed", "kind": "checkbox", "visible": True},
    ]
    specs += [
        {"name": f"e_{emo}", "kind": "slider", "range": (0.0, 1.0, d), "visible": "emotion" in has}
        for emo, d in zip(C.EMOTION_NAMES, C.DEFAULT_EMOTION)
    ]
    specs.append(
        {
            "name": "unconditional_keys", "kind": "checkboxgroup",
            "choices": sorted(has), "default": ["vqscore_8", "dnsmos_ovrl"],
            "visible": True,
        }
    )
    return specs


def build_ui(model_name: str = C.MODEL_TRANSFORMER, app_config: dict | None = None):
    """Build a Gradio Blocks app. Requires gradio to be installed."""
    try:
        import gradio as gr
    except ImportError as e:
        raise ImportError(
            "gradio is not installed; use the HTTP server "
            "(python -m zonos_tpu_torch.serving.server) instead"
        ) from e

    from zonos_tpu_torch.conditioning.cond_dict import supported_language_codes
    from zonos_tpu_torch.serving.model_manager import load_model_if_needed
    from zonos_tpu_torch.serving.pipeline import tts

    model = load_model_if_needed(model_name, app_config or {})
    has = set(model.conditioner_names)

    with gr.Blocks(title="Zonos") as demo:
        text = gr.Textbox(label="Text", value="It would be nice to have time for testing, indeed.")
        language = gr.Dropdown(supported_language_codes, value="en-us", label="Language", visible="espeak" in has)
        speaker_audio = gr.Audio(label="Speaker reference", type="filepath", visible="speaker" in has)
        prefix_audio = gr.Audio(label="Audio prefix", type="filepath")

        sliders = {}
        for spec in control_specs(model.conditioner_names):
            if spec["kind"] == "slider":
                lo, hi, default = spec["range"]
                sliders[spec["name"]] = gr.Slider(lo, hi, value=default, label=spec["name"], visible=spec["visible"])
        seed = gr.Number(value=C.DEFAULT_SEED, label="Seed")
        randomize = gr.Checkbox(value=True, label="Randomize seed")
        out = gr.Audio(label="Output")

        def _generate(text, language, speaker_audio, prefix_audio, seed, randomize, *slider_vals):
            names = list(sliders)
            vals = dict(zip(names, slider_vals))
            emotion = [vals.get(f"e_{n}", d) for n, d in zip(C.EMOTION_NAMES, C.DEFAULT_EMOTION)]
            _, wav, sr, _ = tts(
                model, text, language=language, speaker_audio=speaker_audio,
                prefix_audio=prefix_audio, model_name=model_name, emotion=emotion,
                fmax=vals.get("fmax", 22050.0), pitch_std=vals.get("pitch_std", 20.0),
                speaking_rate=vals.get("speaking_rate", 15.0),
                cfg_scale=vals.get("cfg_scale", 2.0), min_p=vals.get("min_p", 0.1),
                seed=int(seed), randomize_seed=bool(randomize),
            )
            return (sr, wav)

        gr.Button("Generate").click(
            _generate,
            inputs=[text, language, speaker_audio, prefix_audio, seed, randomize, *sliders.values()],
            outputs=[out],
            concurrency_limit=C.CONCURRENCY_LIMIT,
        )
    return demo
