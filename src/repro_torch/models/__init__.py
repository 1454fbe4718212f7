"""The LM substrate of the port: DeepSeek-V2-Lite's MLA + MoE decoder,
its prefill and decode steps (the reference's `repro.models`)."""
