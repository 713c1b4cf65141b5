"""Fault injection and fault handling (counterpart of ``repro/runtime``):
``faultinject`` names the serving path's fault sites, ``fault`` holds the
preemption guard, the straggler monitor and the remesh plans."""
