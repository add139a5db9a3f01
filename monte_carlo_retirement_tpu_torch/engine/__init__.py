"""Engine of the port: kernels, their plain versions, the runner and the
simulator facade. Import the submodules directly."""
