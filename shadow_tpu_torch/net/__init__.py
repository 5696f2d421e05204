"""The network (counterpart of `shadow_tpu/net`): the graph and its
routing tables (`gml`, `graph`), which the flow engine's plan and the
Manager read, and the object plane's packets, interfaces, namespaces,
routers, relays and DNS."""
