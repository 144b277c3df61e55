"""Command-line tools of the port: the decode profiler
(`python -m butterfly_tpu_torch.tools.profile_decode`) and the tensor
split's collective count (`python -m butterfly_tpu_torch.tools.tp_scaling`).
The headline benchmark is `python -m butterfly_tpu_torch.bench`."""
