"""Ported ops: integrator, basis, GMM target, distance field, patches,
barrier, collision, DWA, replay buffer and the K1 fused solve kernel."""
