"""Krylov solvers and operators over the port's SpMV."""
