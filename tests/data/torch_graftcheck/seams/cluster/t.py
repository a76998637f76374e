import urllib.request


def naked(url):
    return urllib.request.urlopen(url)


def seam(url, origin):
    global_nemesis.check_send(origin, url)
    req = urllib.request.Request(url, headers=propagation_headers())
    return urllib.request.urlopen(req)
