"""NAND flash device model and the SLS timeline simulator (numpy copies of
the reference's ``repro.flashsim`` modules)."""
