"""TPC-H data made on the device, and the Q1 plan."""
