"""The request pipeline: params, caches, speaker and prefix audio, tts."""
