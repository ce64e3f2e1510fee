"""Host-environment adapters.

The reference is a plugin inside a scripting host (AviSynth,
reference src/SangNom2.cpp:474-484 registers `SangNom2`/`SangNom` into the
host's function table).  This package provides the same integration for
hosts this framework can reach:

  * `sangnom_jax.hosts.vapoursynth` — a VapourSynth adapter exposing the
    filter as dimension-aware `std.ModifyFrame` graph nodes (VapourSynth is
    the reference's own upstream: the plugin is a port of
    vapoursynth-sangnom, reference README.md:5).
  * `sangnom_jax.hosts.avisynth` — the reference's OWN host contract as a
    Python protocol: verbatim AddFunction signature strings, AVSValue
    binding, Create_ factories erroring through env.throw_error,
    GetFrame/GetParity serving, SetCacheHints MT contract
    (src/SangNom2.cpp:399-484, src/SangNom2.h:61-66).
  * `sangnom_jax.hosts.avs_script` — evaluates AviSynth script TEXT (the
    plugin's usage subset: implicit `last`, OOP chaining, named args)
    against a ScriptEnvironment, so existing .avs recipe lines run
    unmodified.
  * `sangnom_jax.hosts.window` — the shared host-agnostic windowed
    device-batching runner both adapters serve frames through.
  * the in-process CLI host (`sangnom_jax.cli`) and the plain registry
    surface (`sangnom_jax.api.register_plugin_functions`).
"""
